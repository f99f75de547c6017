"""Box geometry on torch tensors.

Same conventions as ``objectdetection_tpu.geometry``: boxes are
``(y1, x1, y2, x2)``; normalized coordinates use the ``(h-1, w-1)`` scale with
a ``[0, 0, 1, 1]`` shift; deltas are ``(dy, dx, log dh, log dw)`` in center
form. Every function works on any leading batch shape and keeps the JAX
version's order of operations.
"""

from __future__ import annotations

import torch

_SHIFT = (0.0, 0.0, 1.0, 1.0)


def _scale_shift(image_shape, like: torch.Tensor):
    h, w = image_shape[0], image_shape[1]
    scale = torch.tensor([h - 1, w - 1, h - 1, w - 1], dtype=torch.float32,
                         device=like.device)
    shift = torch.tensor(_SHIFT, dtype=torch.float32, device=like.device)
    return scale, shift


def norm_boxes(boxes: torch.Tensor, image_shape) -> torch.Tensor:
    """Pixel → normalized coordinates: boxes [..., 4], image_shape (h, w)."""
    scale, shift = _scale_shift(image_shape, boxes)
    return ((boxes - shift) / scale).to(torch.float32)


def denorm_boxes(boxes: torch.Tensor, image_shape, round: bool = True) -> torch.Tensor:
    """Normalized → pixel coordinates (rounded to int32 by default)."""
    scale, shift = _scale_shift(image_shape, boxes)
    out = boxes * scale + shift
    if round:
        return torch.round(out).to(torch.int32)
    return out


def apply_box_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Decode (dy, dx, log dh, log dw) deltas onto boxes: [..., 4]."""
    height = boxes[..., 2] - boxes[..., 0]
    width = boxes[..., 3] - boxes[..., 1]
    center_y = boxes[..., 0] + 0.5 * height
    center_x = boxes[..., 1] + 0.5 * width

    center_y = center_y + deltas[..., 0] * height
    center_x = center_x + deltas[..., 1] * width
    height = height * torch.exp(deltas[..., 2])
    width = width * torch.exp(deltas[..., 3])

    y1 = center_y - 0.5 * height
    x1 = center_x - 0.5 * width
    y2 = y1 + height
    x2 = x1 + width
    return torch.stack([y1, x1, y2, x2], dim=-1)


def decode_box_deltas(boxes: torch.Tensor, deltas: torch.Tensor, stddev,
                      max_log_size: float) -> torch.Tensor:
    """A cascade stage's decode: ``deltas`` [..., 4] (dy, dx, log dh, log dw)
    times ``stddev``, the log sizes clamped to ±``max_log_size`` (mmdetection's
    ``wh_ratio_clip``), applied to ``boxes`` [..., 4]."""
    d = deltas * torch.as_tensor(stddev, dtype=deltas.dtype, device=deltas.device)
    d = torch.cat([d[..., :2], d[..., 2:].clamp(-max_log_size, max_log_size)], dim=-1)
    return apply_box_deltas(boxes, d)


def encode_box_deltas(boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """Deltas taking `boxes` onto `gt_boxes`: [..., 4]."""
    height = boxes[..., 2] - boxes[..., 0]
    width = boxes[..., 3] - boxes[..., 1]
    center_y = boxes[..., 0] + 0.5 * height
    center_x = boxes[..., 1] + 0.5 * width

    gt_height = gt_boxes[..., 2] - gt_boxes[..., 0]
    gt_width = gt_boxes[..., 3] - gt_boxes[..., 1]
    gt_center_y = gt_boxes[..., 0] + 0.5 * gt_height
    gt_center_x = gt_boxes[..., 1] + 0.5 * gt_width

    dy = (gt_center_y - center_y) / height
    dx = (gt_center_x - center_x) / width
    dh = torch.log(gt_height / height)
    dw = torch.log(gt_width / width)
    return torch.stack([dy, dx, dh, dw], dim=-1)


def clip_boxes(boxes: torch.Tensor, window) -> torch.Tensor:
    """Clip boxes [..., 4] to a (y1, x1, y2, x2) window ([4] or [..., 4])."""
    window = torch.as_tensor(window, dtype=boxes.dtype, device=boxes.device)
    wy1, wx1, wy2, wx2 = window[..., 0], window[..., 1], window[..., 2], window[..., 3]
    y1 = torch.minimum(torch.maximum(boxes[..., 0], wy1), wy2)
    x1 = torch.minimum(torch.maximum(boxes[..., 1], wx1), wx2)
    y2 = torch.minimum(torch.maximum(boxes[..., 2], wy1), wy2)
    x2 = torch.minimum(torch.maximum(boxes[..., 3], wx1), wx2)
    return torch.stack([y1, x1, y2, x2], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] → [...] areas (0 for degenerate boxes)."""
    h = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    w = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return h * w


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Dense pairwise IoU: [..., N, 4] × [..., M, 4] → [..., N, M] (leading
    dims broadcast, e.g. shared anchors [A, 4] × per-image GT [B, G, 4])."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    inter_y1 = torch.maximum(a[..., 0], b[..., 0])
    inter_x1 = torch.maximum(a[..., 1], b[..., 1])
    inter_y2 = torch.minimum(a[..., 2], b[..., 2])
    inter_x2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(inter_y2 - inter_y1, min=0.0) * torch.clamp(
        inter_x2 - inter_x1, min=0.0
    )
    area_a = box_area(boxes_a)[..., :, None]
    area_b = box_area(boxes_b)[..., None, :]
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] → [..., N, N] self-IoU: ``iou_matrix(boxes, boxes)``."""
    return iou_matrix(boxes, boxes)
