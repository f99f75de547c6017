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
:func:`anchor_match_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from objectdetection_torch.geometry import iou_matrix
from objectdetection_torch.ops import cuda_build

launches = 0  # kernel launches (never counts the plain version)


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
    if anchors.device.type == "cpu":
        return anchor_match_plain(anchors, gt_boxes, gt_valid)
    if anchors.device.type != "cuda":
        raise ValueError(f"anchor_match: unsupported device {anchors.device}")
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
    valid = gt_valid.to(torch.uint8).contiguous()
    out = AnchorMatch(
        torch.empty((b, a), dtype=torch.float32, device=dev),
        torch.empty((b, a), dtype=torch.int32, device=dev),
        torch.empty((b, g), dtype=torch.float32, device=dev),
        torch.empty((b, g), dtype=torch.int32, device=dev),
    )
    if a == 0 or b == 0:
        return out
    keys = torch.empty((b, g), dtype=torch.int64, device=dev)
    global launches
    fn = cuda_build.load("anchor_match").anchor_match
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = fn(anchors.data_ptr(), gt.data_ptr(), valid.data_ptr(), b, a, g,
                    *[t.data_ptr() for t in out], keys.data_ptr(), stream)
    cuda_build.check(status, "anchor_match")
    launches += 1
    return out
