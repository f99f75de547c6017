"""Image molding and unmolding: source pixels in, detections in source pixels out.

Port of ``objectdetection_tpu.data.preprocess``. Two molds, as in JAX, each
mirroring its own counterpart (they may place a window one pixel apart and
are not unified):

- :func:`mold_image_host` (numpy, float64 scale, Python ``round``) resizes
  with :func:`resize_bilinear`, a numpy copy of ``cv2.resize(float32,
  INTER_LINEAR)``: half-pixel centres, a replicated border, no antialiasing
  when it scales down. The server and the ``infer`` command mold with it.
- :func:`mold_image_device` / :func:`mold_batch_device` (torch, on the
  images' device, f32 with ``torch.round``) mirror
  ``jax.image.scale_and_translate(method="linear")``: an antialiased
  triangle kernel that widens to 1/scale when it scales down, normalised
  per output pixel, with a fractional translation. The per-axis weight
  matrices (:func:`scale_translate_weights`) are applied as two f32
  products with TF32 off. The kernel blends the content's edge with the
  canvas's zeros before the window mask cuts it, as JAX's does.

:func:`unmold_detections` (torch, f32) and :func:`unmold_detections_np`
(numpy, float64) map normalized detections back to the source image's
integer pixels, with a validity flag instead of deleting empty rows.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from objectdetection_torch.config import DetectorConfig
from objectdetection_torch.geometry import norm_boxes


class ImageMeta(NamedTuple):
    """Per-image provenance threaded through the pipeline (batched tensors)."""

    image_id: torch.Tensor  # [B] int32
    original_shape: torch.Tensor  # [B, 3] int32 (H, W, C) before molding
    image_shape: torch.Tensor  # [B, 3] int32 after molding
    window: torch.Tensor  # [B, 4] float32 (y1, x1, y2, x2) pixels of the real image
    scale: torch.Tensor  # [B] float32
    active_class_ids: torch.Tensor  # [B, num_classes] int32

    def to_vector(self) -> torch.Tensor:
        """Reference-layout meta vector [B, 12 + num_classes]."""
        return torch.cat([
            self.image_id[:, None].to(torch.float32),
            self.original_shape.to(torch.float32),
            self.image_shape.to(torch.float32),
            self.window.to(torch.float32),
            self.scale[:, None].to(torch.float32),
            self.active_class_ids.to(torch.float32),
        ], dim=1)


def compute_resize_params(orig_h, orig_w, min_dim: int, max_dim: int,
                          min_scale: float = 0.0):
    """Scale and centred padding of the square resize, in f32 as JAX computes
    them: (scale, new_h, new_w, top_pad, left_pad) tensors of the inputs'
    shape, on their device."""
    dev = orig_h.device if isinstance(orig_h, torch.Tensor) else None
    orig_h = torch.as_tensor(orig_h, dtype=torch.float32, device=dev)
    orig_w = torch.as_tensor(orig_w, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=orig_h.device)
    scale = torch.maximum(one, min_dim / torch.minimum(orig_h, orig_w))
    if min_scale:
        scale = torch.maximum(scale, torch.full_like(scale, min_scale))
    scale = torch.minimum(scale, max_dim / torch.maximum(orig_h, orig_w))
    new_h = torch.round(orig_h * scale)
    new_w = torch.round(orig_w * scale)
    top_pad = torch.floor((max_dim - new_h) / 2)
    left_pad = torch.floor((max_dim - new_w) / 2)
    return scale, new_h, new_w, top_pad, left_pad


def scale_translate_weights(in_size: int, out_size: int, scale: torch.Tensor,
                            translation: torch.Tensor) -> torch.Tensor:
    """[..., out, in] f32 weights of ``scale_and_translate``'s linear kernel
    with antialiasing, for scale and translation of shape [...]."""
    dev = scale.device
    scale = scale.to(torch.float32)[..., None, None]
    translation = translation.to(torch.float32)[..., None, None]
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_idx = torch.arange(out_size, dtype=torch.float32, device=dev)[:, None]
    in_idx = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :]
    sample_f = (out_idx + 0.5) * inv_scale - translation * inv_scale - 0.5
    x = torch.abs(sample_f - in_idx) / kernel_scale
    weights = torch.clamp(1 - torch.abs(x), min=0.0)
    total = weights.sum(dim=-1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, weights, torch.zeros_like(weights))


@contextlib.contextmanager
def _exact_f32_products():
    """TF32 off for the mold's products: they must be f32 on the card."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _mold_batch(images: torch.Tensor, orig_shapes: torch.Tensor, config: DetectorConfig):
    b, hc, wc, c = images.shape
    d = config.image_max_dim
    shapes = torch.as_tensor(orig_shapes, device=images.device)
    scale, new_h, new_w, top, left = compute_resize_params(
        shapes[:, 0].to(torch.float32), shapes[:, 1].to(torch.float32),
        config.image_min_dim, d, config.image_min_scale)
    wy = scale_translate_weights(hc, d, scale, top)  # [B, D, Hc]
    wx = scale_translate_weights(wc, d, scale, left)  # [B, D, Wc]
    x = images.to(torch.float32)
    with _exact_f32_products():
        rows = torch.bmm(wy, x.reshape(b, hc, wc * c))  # [B, D, Wc·C]
        rows = rows.reshape(b, d, wc, c).permute(0, 1, 3, 2).reshape(b, d * c, wc)
        out = torch.bmm(rows, wx.transpose(1, 2))  # [B, D·C, D]
    resized = out.reshape(b, d, c, d).permute(0, 1, 3, 2)
    # zero outside the window (the kernel bleeds a fraction of a pixel past
    # the content edge)
    yy = torch.arange(d, dtype=torch.float32, device=images.device)[None, :, None]
    xx = torch.arange(d, dtype=torch.float32, device=images.device)[None, None, :]
    t, l = top[:, None, None], left[:, None, None]
    inside = ((yy >= t) & (yy < t + new_h[:, None, None])
              & (xx >= l) & (xx < l + new_w[:, None, None]))
    resized = torch.where(inside[..., None], resized, torch.zeros_like(resized))
    mean = torch.tensor(config.mean_pixel, dtype=torch.float32, device=images.device)
    windows = torch.stack([top, left, top + new_h, left + new_w], dim=1)
    return resized - mean, windows, scale


def mold_image_device(image, orig_shape, config: DetectorConfig):
    """Mold one image placed top-left on a static canvas, on its device.

    image: [Hc, Wc, 3] canvas (zero past the content); orig_shape: [2] (h, w)
    of the content. Returns (molded [D, D, 3] f32 mean-subtracted, window [4]
    f32 pixels, scale [] f32).
    """
    image = torch.as_tensor(image)
    shape = torch.as_tensor(orig_shape, device=image.device)
    molded, windows, scales = _mold_batch(image[None], shape[None], config)
    return molded[0], windows[0], scales[0]


def mold_batch_device(images, orig_shapes, config: DetectorConfig,
                      image_ids: Optional[torch.Tensor] = None):
    """Mold a batch of canvases [B, Hc, Wc, 3] with content shapes [B, 2], on
    their device. Returns (molded [B, D, D, 3], :class:`ImageMeta`)."""
    images = torch.as_tensor(images)
    shapes = torch.as_tensor(orig_shapes, device=images.device)
    b = images.shape[0]
    molded, windows, scales = _mold_batch(images, shapes, config)
    d = config.image_max_dim
    dev = images.device
    ids = image_ids if image_ids is not None else torch.arange(b, device=dev)
    meta = ImageMeta(
        image_id=torch.as_tensor(ids, device=dev).to(torch.int32),
        original_shape=torch.cat([shapes.to(torch.int32),
                                  torch.full((b, 1), 3, dtype=torch.int32, device=dev)], 1),
        image_shape=torch.tensor([[d, d, 3]], dtype=torch.int32, device=dev).repeat(b, 1),
        window=windows,
        scale=scales,
        active_class_ids=torch.ones((b, config.num_classes), dtype=torch.int32, device=dev),
    )
    return molded, meta


def _linear_taps(src: int, dst: int):
    """Source rows (s0, s1) and f32 weight of s1 for each of ``dst`` outputs,
    as cv2's INTER_LINEAR computes them: half-pixel centres, a replicated
    border."""
    scale = src / dst
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    a = (f - s.astype(np.float32)).astype(np.float32)
    low, high = s < 0, s >= src - 1
    s[low], a[low] = 0, 0
    s[high], a[high] = src - 1, 0
    return s, np.minimum(s + 1, src - 1), a


def resize_bilinear(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=INTER_LINEAR)`` for a float32
    [H, W] or [H, W, C] array: the horizontal blend of each source row, then
    the vertical one, in f32."""
    image = np.asarray(image, np.float32)
    h, w = size
    y0, y1, ay = _linear_taps(image.shape[0], h)
    x0, x1, ax = _linear_taps(image.shape[1], w)
    extra = (None,) * (image.ndim - 2)
    axc = ax[(slice(None),) + extra]
    bx = np.float32(1) - axc
    rows = image[:, x0] * bx + image[:, x1] * axc  # [H, w, ...]
    ayc = ay[(slice(None), None) + extra]
    by = np.float32(1) - ayc
    return (rows[y0] * by + rows[y1] * ayc).astype(np.float32)


def mold_image_host(image: np.ndarray, config: DetectorConfig):
    """Host mold of a source image [H, W, 3]: aspect-preserving bilinear
    resize, centred zero padding to the ``image_max_dim`` square, mean
    subtraction. Returns (molded [D, D, 3] float32, window [4] int32, scale)."""
    h, w = image.shape[:2]
    d = config.image_max_dim
    scale = max(1.0, config.image_min_dim / min(h, w))
    if config.image_min_scale:
        scale = max(scale, config.image_min_scale)
    scale = min(scale, d / max(h, w))
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    if scale != 1.0:
        image = resize_bilinear(image.astype(np.float32), (new_h, new_w))
    top = (d - new_h) // 2
    left = (d - new_w) // 2
    canvas = np.zeros((d, d, 3), np.float32)
    canvas[top: top + new_h, left: left + new_w] = image
    canvas -= np.asarray(config.mean_pixel, np.float32)
    window = np.array([top, left, top + new_h, left + new_w], np.int32)
    return canvas, window, scale


def unmold_detections(detections: torch.Tensor, window, image_shape: Tuple[int, int],
                      original_shape):
    """Detections [N, 6] (normalized y1, x1, y2, x2, class id, score) → source
    image pixels, on their device in f32: (boxes [N, 4] int32, class ids [N]
    int32, scores [N], valid [N] bool)."""
    dev = detections.device
    boxes = detections[:, :4]
    class_ids = detections[:, 4].to(torch.int32)
    scores = detections[:, 5]
    window = torch.as_tensor(window, dtype=torch.float32, device=dev)
    wy1, wx1, wy2, wx2 = norm_boxes(window, image_shape).unbind(-1)
    shift = torch.stack([wy1, wx1, wy1, wx1])
    scale = torch.stack([wy2 - wy1, wx2 - wx1, wy2 - wy1, wx2 - wx1])
    boxes = (boxes - shift) / scale
    orig = torch.as_tensor(original_shape, device=dev)
    oh, ow = orig[0], orig[1]
    scale_px = torch.stack([oh - 1, ow - 1, oh - 1, ow - 1]).to(torch.float32)
    shift_px = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    pix = torch.round(boxes * scale_px + shift_px).to(torch.int32)
    area = (pix[:, 2] - pix[:, 0]) * (pix[:, 3] - pix[:, 1])
    valid = (class_ids > 0) & (area > 0)
    return pix, class_ids, scores, valid


def unmold_detections_np(detections: np.ndarray, window: np.ndarray,
                         image_shape: Tuple[int, int], original_shape):
    """Numpy (float64) mirror of :func:`unmold_detections` for host loops."""
    detections = np.asarray(detections)
    boxes = detections[:, :4]
    class_ids = detections[:, 4].astype(np.int32)
    scores = detections[:, 5]
    h, w = image_shape
    nwin = (np.asarray(window, np.float64) - np.array([0, 0, 1, 1])) / np.array(
        [h - 1, w - 1, h - 1, w - 1])
    wy1, wx1, wy2, wx2 = nwin
    shift = np.array([wy1, wx1, wy1, wx1])
    scale = np.array([wy2 - wy1, wx2 - wx1, wy2 - wy1, wx2 - wx1])
    boxes = (boxes - shift) / scale
    oh, ow = float(original_shape[0]), float(original_shape[1])
    pix = np.around(
        boxes * np.array([oh - 1, ow - 1, oh - 1, ow - 1]) + np.array([0, 0, 1, 1])
    ).astype(np.int32)
    area = (pix[:, 2] - pix[:, 0]) * (pix[:, 3] - pix[:, 1])
    valid = (class_ids > 0) & (area > 0)
    return pix, class_ids, scores, valid


def unmold_masks(masks: torch.Tensor, detections: torch.Tensor) -> torch.Tensor:
    """Each detection's mask of its own class: masks [N, mh, mw, C] → [N, mh, mw]
    (pasting into the image is :func:`~objectdetection_torch.data.masks.
    paste_detection_masks`)."""
    class_ids = detections[:, 4].to(torch.int64)
    idx = class_ids[:, None, None, None].expand(*masks.shape[:3], 1)
    return torch.gather(masks, -1, idx)[..., 0]
