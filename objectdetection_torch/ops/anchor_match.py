"""Anchor↔GT IoU matching: plain PyTorch version and the CUDA kernel.

Port of ``objectdetection_tpu.ops.anchor_match`` (``anchor_match_xla``) and
of the Pallas kernel ``_match_kernel``, whose CUDA counterpart is
``csrc/anchor_match.cu``. The port carries an explicit batch dimension:
anchors [A, 4] are shared, GT boxes [B, G, 4] and their validity [B, G] are
per image.

For each image, invalid GTs count as IoU 0; per anchor, the best IoU and the
index of its GT; per GT, the best IoU and the index of its anchor. Ties go to
the lowest index, so a GT that is invalid or overlaps no anchor comes out as
(0, 0), as in JAX.

:func:`anchor_match` launches the kernel for CUDA tensors and runs
:func:`anchor_match_plain` for CPU tensors. The kernel tests only the GTs
that can overlap each tile of 128 consecutive anchors (its cull is modelled
in tests/test_torch_anchor_match.py), and is one launch a call: its
per-GT keys live in a scratch kept per (device, stream, B, G) that the
kernel's last block leaves clean for the next call.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from objectdetection_torch.geometry import iou_matrix
from objectdetection_torch.ops import cuda_build

_MATCH = cuda_build.Entry("anchor_match", "anchor_match",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)
EMPTY_KEY = 0xFFFFFFFF  # the kernel's per-GT key for IoU 0, anchor 0
_scratch: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


class AnchorMatch(NamedTuple):
    anchor_max: torch.Tensor  # [B, A] f32 best IoU per anchor
    anchor_argmax: torch.Tensor  # [B, A] int32 index of its GT
    gt_max: torch.Tensor  # [B, G] f32 best IoU per GT
    gt_argmax: torch.Tensor  # [B, G] int32 index of its anchor


def anchor_match_plain(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                       gt_valid: torch.Tensor) -> AnchorMatch:
    """Dense [B, A, G] IoU, invalid GTs at 0, then max/argmax both ways."""
    iou = iou_matrix(anchors.to(torch.float32), gt_boxes.to(torch.float32))
    iou = torch.where(gt_valid.to(torch.bool)[:, None, :], iou, torch.zeros_like(iou))
    amax, aarg = iou.max(dim=2)
    gmax, garg = iou.max(dim=1)
    return AnchorMatch(amax, aarg.to(torch.int32), gmax, garg.to(torch.int32))


def anchor_match(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_valid: torch.Tensor) -> AnchorMatch:
    """anchors [A, 4] × gt_boxes [B, G, 4] (+ gt_valid [B, G]) → AnchorMatch."""
    if not cuda_build.takes_kernel(anchors, "anchor_match"):
        return anchor_match_plain(anchors, gt_boxes, gt_valid)
    a, four = anchors.shape
    b, g, four_g = gt_boxes.shape
    if four != 4 or four_g != 4 or gt_valid.shape != (b, g) or g == 0:
        raise ValueError(f"anchor_match: bad shapes {anchors.shape}, {gt_boxes.shape}, "
                         f"{gt_valid.shape}")
    if gt_boxes.device != anchors.device or gt_valid.device != anchors.device:
        raise ValueError("anchor_match kernel: inputs on different devices")
    dev = anchors.device
    anchors = anchors.to(torch.float32).contiguous()
    gt = gt_boxes.to(torch.float32).contiguous()
    # bool and uint8 hold 0 / nonzero in one byte: the kernel reads either as they are
    valid = (gt_valid if gt_valid.dtype in (torch.bool, torch.uint8)
             else gt_valid.to(torch.uint8)).contiguous()
    out = AnchorMatch(
        torch.empty((b, a), dtype=torch.float32, device=dev),
        torch.empty((b, a), dtype=torch.int32, device=dev),
        torch.empty((b, g), dtype=torch.float32, device=dev),
        torch.empty((b, g), dtype=torch.int32, device=dev),
    )
    if a == 0 or b == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev, stream, b, g)
    if key not in _scratch:  # keys at IoU 0, anchor 0 and the done counter at 0
        _scratch[key] = (torch.full((b, g), EMPTY_KEY, dtype=torch.int64, device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev))
    keys, done = _scratch[key]
    _MATCH.launch(dev, anchors.data_ptr(), gt.data_ptr(), valid.data_ptr(), b, a, g,
                  *[t.data_ptr() for t in out], keys.data_ptr(), done.data_ptr())
    return out
