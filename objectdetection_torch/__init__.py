"""PyTorch/CUDA port of the detector in ``objectdetection_tpu``.

Mask R-CNN inference on an NVIDIA Hopper card: ``detector.make_infer_fn``.
The NMS and ROIAlign kernels are hand-written CUDA under ``csrc/``, built on
first use (``ops/cuda_build.py``). The package imports torch and numpy only.
"""

__version__ = "0.1.0"
