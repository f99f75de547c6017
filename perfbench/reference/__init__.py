"""The plain reference that decides each cell's ``correct``.

Plain PyTorch and NumPy in float32 (TF32 off while it runs), written from
the published description of Mask R-CNN (He et al., arXiv:1703.06870) at
the conventions of the program it judges (SAME padding, normalized ``(y1, x1, y2, x2)`` boxes, the
``(h - 1, w - 1)`` anchor normalization, the FPN level rule of the paper's
eq. 1, greedy NMS, corner-aligned bilinear ROIAlign). It imports nothing of
the program: the weights come from :mod:`perfbench.weights` and the inputs
from the traffic generator, and both sides get the same.

:class:`~perfbench.reference.layers.Precision` computes the same network in
a lower precision for the controls (int4 where the program runs int8, fp8
where it runs bf16).
"""
