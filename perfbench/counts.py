"""Operations and bytes from shapes, and the card's published peaks.

A network's work is a list of :class:`Op` rows: the layer it belongs to
(``backbone``, ``rpn``, ``box_head``, ``mask_head``), a name,
the multiply-add operations it needs (2 per multiply-add, counted from its
shapes whatever kernel runs it) and the arithmetic it runs in on the card
(``int8``, ``bf16``, ``tf32`` or ``f32``), whose peak :data:`PEAKS` gives.
Elementwise work (BatchNorm, ReLU, upsampling, softmax), ROIAlign's blends
and NMS are not counted: next to the convolutions they are a rounding
error, and a roofline share built on them could only read lower.

ROIAlign's bound (:func:`roi_align_bound_s`) is the byte bound the kernel
table uses: every feature row that a sample's corner reads with a nonzero
weight once, the boxes, the output and the epilogue's scale map once, at
the HBM rate (or the blend's operations at the f32 rate, if larger).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from perfbench.reference.backbone import FPN_LATERALS, stages
from perfbench.reference.layers import corners

# NVIDIA H100 SXM data sheet, dense: operations or bytes per second
PEAKS = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


class Op(NamedTuple):
    layer: str
    name: str
    ops: float
    kind: str


def conv_ops(b: int, ho: int, wo: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * b * ho * wo * cin * cout * k * k


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def resnet_fpn(b: int, hw: Tuple[int, int], model: str, channels: int, kind: str,
               stem_kind: str) -> List[Op]:
    """The ResNet's and the FPN's convolutions for a batch of ``b`` images."""
    h, w = _out(hw[0], 2), _out(hw[1], 2)
    ops = [Op("backbone", "conv1", conv_ops(b, h, w, 3, 64, 7), stem_kind)]
    h, w = _out(h, 2), _out(w, 2)  # max pool
    c = 64
    level_hw = []
    for stage, (f1, f2, f3), stride, blocks in stages(model):
        for i in range(blocks):
            s = stride if i == 0 else 1
            ho, wo = _out(h, s), _out(w, s)
            n = f"res{stage}{chr(ord('a') + i)}"
            if i == 0:
                ops.append(Op("backbone", n + "_branch1", conv_ops(b, ho, wo, c, f3, 1), kind))
            ops += [Op("backbone", n + "_branch2a", conv_ops(b, ho, wo, c, f1, 1), kind),
                    Op("backbone", n + "_branch2b", conv_ops(b, ho, wo, f1, f2, 3), kind),
                    Op("backbone", n + "_branch2c", conv_ops(b, ho, wo, f2, f3, 1), kind)]
            h, w, c = ho, wo, f3
        level_hw.append((h, w))
    for (name, cin), (lh, lw) in zip(FPN_LATERALS, reversed(level_hw)):
        ops.append(Op("backbone", name, conv_ops(b, lh, lw, cin, channels, 1), kind))
    for i, (lh, lw) in zip((2, 3, 4, 5), level_hw):
        ops.append(Op("backbone", f"fpn_p{i}", conv_ops(b, lh, lw, channels, channels, 3), kind))
    return ops


def pyramid_hw(hw: Tuple[int, int], strides: Sequence[int]) -> List[Tuple[int, int]]:
    return [(_out(hw[0], s), _out(hw[1], s)) for s in strides]


def mask_rcnn(sizes: dict, b: int, kinds: dict) -> List[Op]:
    """Every counted operation of a Mask R-CNN inference call at ``sizes``
    (``post_nms_rois_inference`` ROIs through the box head, the
    ``detection_post_nms_instances`` rows through the mask head). ``kinds``
    maps ``stem``, ``backbone``, ``rpn``, ``head``, ``deconv``, ``float``
    (the logits, box deltas and mask outputs) to an arithmetic."""
    hw = tuple(sizes["image_shape"][:2])
    c = sizes["fpn_channels"]
    k = len(sizes["rpn_anchor_ratios"])
    nc = sizes["num_classes"]
    ops = resnet_fpn(b, hw, sizes["backbone"], c, kinds["backbone"], kinds["stem"])
    for lh, lw in pyramid_hw(hw, sizes["backbone_strides"]):
        ops += [Op("rpn", "rpn_conv_shared", conv_ops(b, lh, lw, c, 512, 3), kinds["rpn"]),
                Op("rpn", "rpn_heads", conv_ops(b, lh, lw, 512, 6 * k, 1), kinds["rpn"])]
    r = b * sizes["post_nms_rois_inference"]
    ph, pw = sizes["pool_shape"]
    ops += [Op("box_head", "fc1", 2.0 * r * ph * pw * c * 1024, kinds["head"]),
            Op("box_head", "fc2", 2.0 * r * 1024 * 1024, kinds["head"]),
            Op("box_head", "logits_and_deltas", 2.0 * r * 1024 * nc * 5, kinds["float"])]
    n = b * sizes["detection_post_nms_instances"]
    mh, mw = sizes["mask_pool_shape"]
    ops += [Op("mask_head", f"conv{i}", conv_ops(n, mh, mw, c if i == 1 else 256, 256, 3),
               kinds["head"]) for i in range(1, 5)]
    ops += [Op("mask_head", "deconv", conv_ops(n, mh, mw, 256, 256, 2), kinds["deconv"]),
            Op("mask_head", "mask_logits", 2.0 * n * 4 * mh * mw * 256, kinds["float"])]
    return ops


def seconds_at_peak(ops: Sequence[Op], layers: Sequence[str] = ()) -> float:
    """The least time the counted work takes at its arithmetic's peak (only
    the ``layers`` named, if any)."""
    return sum(o.ops / PEAKS[o.kind] for o in ops if not layers or o.layer in layers)


def touched_rows(level_hw, boxes: torch.Tensor, image_hw, crop) -> int:
    """Distinct rows of the flattened pyramid that a nonzero bilinear weight reads."""
    rows = torch.cat([r[(w != 0) & (r >= 0)] for r, w in corners(level_hw, boxes, image_hw,
                                                                  crop)])
    return int(torch.unique(rows).numel())


def roi_align_bound_s(level_hw, channels: int, boxes: torch.Tensor, image_hw, crop,
                      in_bytes: int, out_bytes: int, map_bytes: int = 0) -> float:
    """The least time one pyramid ROIAlign call can take: its bytes at the
    HBM rate, or its blends (7 operations an output, 8 with an epilogue
    map) at the f32 rate, whichever is larger."""
    b, r = boxes.shape[:2]
    outs = b * r * crop[0] * crop[1] * channels
    rows = touched_rows(level_hw, boxes, image_hw, crop)
    nbytes = rows * channels * in_bytes + boxes.numel() * 4 + outs * out_bytes + map_bytes
    ops = outs * (8 if map_bytes else 7)
    return max(nbytes / PEAK_BYTES, ops / PEAKS["f32"])
