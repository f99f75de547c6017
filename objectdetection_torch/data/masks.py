"""Instance masks: mini-masks, and masks pasted at the image's own size.

Port of ``objectdetection_tpu.data.masks``. :func:`minimize_masks` crops
each mask to its box through the port's ``crop_and_resize``;
:func:`expand_masks` and :func:`paste_detection_masks` resize on the host
with :func:`~objectdetection_torch.data.preprocess.resize_bilinear`, the
numpy copy of the ``cv2.resize`` the JAX package calls.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from objectdetection_torch.data.preprocess import resize_bilinear
from objectdetection_torch.ops.roi_align import crop_and_resize


def minimize_masks(boxes, masks, mini_shape: Tuple[int, int]) -> torch.Tensor:
    """Crop each instance mask [N, H, W] to its pixel box [N, 4] (y2, x2
    exclusive) at ``mini_shape``: [N, mh, mw] f32 of rounded values."""
    masks = torch.as_tensor(masks, dtype=torch.float32)
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=masks.device)
    n, h, w = masks.shape
    # pixel box → normalized corner-aligned coordinates over (h-1, w-1);
    # exclusive y2 → inclusive last row y2-1
    norm = torch.stack([
        boxes[:, 0] / (h - 1),
        boxes[:, 1] / (w - 1),
        (boxes[:, 2] - 1) / (h - 1),
        (boxes[:, 3] - 1) / (w - 1),
    ], dim=1)
    out = crop_and_resize(masks[..., None], norm[:, None], tuple(mini_shape))
    return torch.round(out[:, 0, :, :, 0])


def _box_region(box, h: int, w: int):
    y1, x1, y2, x2 = [int(round(float(v))) for v in box]
    y1, x1 = max(y1, 0), max(x1, 0)
    y2, x2 = min(y2, h), min(x2, w)
    return y1, x1, y2, x2


def expand_masks(boxes, mini_masks, image_shape: Tuple[int, int]) -> np.ndarray:
    """Paste mini-masks back into full-image frames: [N, H, W] float32 of
    rounded values (the inverse of :func:`minimize_masks`)."""
    boxes = np.asarray(boxes)
    mini = np.asarray(mini_masks, np.float32)
    h, w = image_shape
    out = np.zeros((mini.shape[0], h, w), np.float32)
    for i in range(mini.shape[0]):
        y1, x1, y2, x2 = _box_region(boxes[i], h, w)
        if y2 <= y1 or x2 <= x1:
            continue
        out[i, y1:y2, x1:x2] = np.round(resize_bilinear(mini[i], (y2 - y1, x2 - x1)))
    return out


def paste_detection_masks(soft_masks, boxes, image_shape: Tuple[int, int],
                          threshold: float = 0.5) -> np.ndarray:
    """Per-detection soft masks [N, mh, mw] and pixel boxes [N, 4] → binary
    masks [N, H, W] at the image's own size."""
    boxes = np.asarray(boxes)
    soft = np.asarray(soft_masks, np.float32)
    h, w = image_shape
    out = np.zeros((soft.shape[0], h, w), bool)
    for i in range(soft.shape[0]):
        y1, x1, y2, x2 = _box_region(boxes[i], h, w)
        if y2 <= y1 or x2 <= x1:
            continue
        out[i, y1:y2, x1:x2] = resize_bilinear(soft[i], (y2 - y1, x2 - x1)) >= threshold
    return out
