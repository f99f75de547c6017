"""Multilevel ROIAlign (crop_and_resize): plain PyTorch version and CUDA kernel.

Port of ``objectdetection_tpu.ops.roi_align`` (``roi_levels``,
``batched_multilevel_roi_align``) and of the Pallas kernel
``objectdetection_tpu/ops/roi_align_pallas.py`` ``_kernel``, whose CUDA
counterpart is ``csrc/roi_align.cu``.

Bilinear semantics follow ``tf.image.crop_and_resize(method="bilinear")``:
for an output grid of size P, sample i of a box lies at
``y1*(H-1) + i*((y2-y1)*(H-1)/(P-1))`` on the box's pyramid level (boxes in
normalized, corner-aligned coordinates). Each box's level comes from the FPN
assignment rule; zero-area boxes pin to the finest level.

:func:`batched_multilevel_roi_align` launches the kernel for CUDA features
and runs :func:`batched_multilevel_roi_align_plain` for CPU features.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from objectdetection_torch.ops import cuda_build

launches = 0  # kernel launches (never counts the plain version)

LN2 = float(np.log(np.float32(2.0)).astype(np.float32))
_MAX_POOL = 32


def _canonical_scale(image_area: float, canonical_size: float = 224.0) -> float:
    """canonical_size / sqrt(image area), rounded to f32 as the JAX version does."""
    return float(np.float32(canonical_size / np.sqrt(image_area)))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    # divide by a device tensor, not a Python number: CUDA turns division by a
    # host scalar into multiplication by its reciprocal, which rounds differently
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def roi_levels(
    boxes: torch.Tensor,
    image_area: float,
    min_level: int = 2,
    max_level: int = 5,
    canonical_level: int = 4,
    canonical_size: float = 224.0,
) -> torch.Tensor:
    """FPN level per ROI: boxes [..., 4] normalized → int64 levels in [min, max]."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    area = h * w
    scale = torch.sqrt(torch.clamp(area, min=1e-12)) / _f32(
        _canonical_scale(image_area, canonical_size), boxes
    )
    log2 = torch.log(scale) / _f32(LN2, boxes)
    lvl = canonical_level + torch.round(log2).to(torch.int64)
    lvl = torch.where(area > 0, lvl, torch.full_like(lvl, min_level))
    return torch.clamp(lvl, min_level, max_level)


def _bilinear_weights_1d(coord: torch.Tensor, size: torch.Tensor):
    i0 = torch.floor(coord)
    w1 = coord - i0
    i0 = i0.to(torch.int64)
    i1 = torch.minimum(i0 + 1, size - 1)
    i0 = torch.minimum(torch.clamp(i0, min=0), size - 1)
    return i0, i1, w1


def _corners(level_hw, boxes, image_shape, crop_size):
    """Bilinear corners of every sample: four (flat-table rows [N], f32
    weights [N]) pairs, N = B·R·ph·pw, for levels of the given (H, W) whose
    [B, H, W, C] maps are flattened and concatenated level after level."""
    b, r = boxes.shape[:2]
    ph, pw = crop_size
    dev = boxes.device
    heights = torch.tensor([h for h, _ in level_hw], device=dev)
    widths = torch.tensor([w for _, w in level_hw], device=dev)
    sizes = heights * widths
    level_base = torch.cumsum(sizes * b, 0) - sizes * b

    boxes = boxes.to(torch.float32)
    li = roi_levels(boxes, float(image_shape[0] * image_shape[1]),
                    max_level=1 + len(level_hw)) - 2
    lh, lw = heights[li], widths[li]  # [B, R]
    image_idx = torch.arange(b, device=dev)[:, None]
    row0 = level_base[li] + image_idx * sizes[li]
    y1, x1, y2, x2 = boxes.unbind(-1)

    def grid(p, lo, hi, size):
        steps = torch.arange(p, dtype=torch.float32, device=dev)
        sizef = size.to(torch.float32)[..., None]
        if p > 1:
            return lo[..., None] * (sizef - 1) + steps * (
                (hi - lo)[..., None] * (sizef - 1) / _f32(p - 1, boxes)
            )
        return 0.5 * (lo + hi)[..., None] * (sizef - 1)

    ys = grid(ph, y1, y2, lh)  # [B, R, ph]
    xs = grid(pw, x1, x2, lw)  # [B, R, pw]
    y0i, y1i, wy = _bilinear_weights_1d(ys, lh[..., None])
    x0i, x1i, wx = _bilinear_weights_1d(xs, lw[..., None])
    n = b * r * ph * pw

    def flat_idx(yi, xi):
        return (row0[..., None, None] + yi[..., :, None] * lw[..., None, None]
                + xi[..., None, :]).reshape(-1)

    def wprod(a, b_):
        return (a[..., :, None] * b_[..., None, :]).reshape(n)

    return [
        (flat_idx(y0i, x0i), wprod(1 - wy, 1 - wx)),
        (flat_idx(y0i, x1i), wprod(1 - wy, wx)),
        (flat_idx(y1i, x0i), wprod(wy, 1 - wx)),
        (flat_idx(y1i, x1i), wprod(wy, wx)),
    ]


def touched_rows(features: Sequence[torch.Tensor], boxes, image_shape, crop_size) -> int:
    """Distinct feature rows (C values each) that the samples of `boxes` need:
    corners with a nonzero bilinear weight."""
    corners = _corners([f.shape[1:3] for f in features], boxes, image_shape, crop_size)
    rows = torch.cat([rows[w != 0] for rows, w in corners])
    return int(torch.unique(rows).numel())


def batched_multilevel_roi_align_plain(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    image_shape: Tuple[int, int],
    crop_size: Tuple[int, int],
) -> torch.Tensor:
    """features: P2..P5, each [B, H_l, W_l, C]; boxes [B, R, 4] → [B, R, ph, pw, C].

    The four-gather form of ``roi_align.batched_multilevel_roi_align``: every
    level flattens into one [Σ B·H_l·W_l, C] table and each bilinear corner is
    one row gather; the weighted sum runs in the feature dtype.
    """
    features = list(features)
    b, r = boxes.shape[:2]
    c = features[0].shape[-1]
    flat = torch.cat([f.reshape(-1, c) for f in features], dim=0)
    dtype = flat.dtype
    corners = _corners([f.shape[1:3] for f in features], boxes, image_shape, crop_size)
    (r00, w00), (r01, w01), (r10, w10), (r11, w11) = corners
    out = (
        flat[r00] * w00[:, None].to(dtype)
        + flat[r01] * w01[:, None].to(dtype)
        + flat[r10] * w10[:, None].to(dtype)
        + flat[r11] * w11[:, None].to(dtype)
    )
    return out.reshape(b, r, *crop_size, c)


def batched_multilevel_roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    image_shape: Tuple[int, int],
    crop_size: Tuple[int, int],
) -> torch.Tensor:
    """Pyramid ROIAlign: P2..P5 [B, H_l, W_l, C] (f32 or bf16) × boxes
    [B, R, 4] f32 → [B, R, ph, pw, C] in the feature dtype."""
    features = list(features)
    if features[0].device.type == "cpu":
        return batched_multilevel_roi_align_plain(features, boxes, image_shape, crop_size)
    if features[0].device.type != "cuda":
        raise ValueError(f"roi_align: unsupported device {features[0].device}")
    if len(features) != 4:
        raise ValueError("roi_align kernel: expects exactly the 4 levels P2..P5")
    dtype = features[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align kernel: unsupported dtype {dtype}")
    b, r, four = boxes.shape
    c = features[0].shape[-1]
    for f in features:
        if f.dtype != dtype or f.shape[0] != b or f.shape[-1] != c or f.device != boxes.device:
            raise ValueError("roi_align kernel: levels disagree in dtype, batch, channels or device")
    ph, pw = crop_size
    if four != 4 or not (1 <= ph <= _MAX_POOL and 1 <= pw <= _MAX_POOL):
        raise ValueError(f"roi_align kernel: bad boxes {boxes.shape} or crop {crop_size}")
    feats = [f.contiguous() for f in features]  # NHWC rows, channel fastest
    boxes = boxes.to(torch.float32).contiguous()
    out = torch.empty((b, r, ph, pw, c), dtype=dtype, device=boxes.device)
    if b == 0 or r == 0:
        return out
    global launches
    lib = cuda_build.load("roi_align")
    fn = lib.roi_align_f32 if dtype == torch.float32 else lib.roi_align_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    hw = (ctypes.c_int * 8)(*[d for f in feats for d in f.shape[1:3]])
    scale = _canonical_scale(float(image_shape[0] * image_shape[1]))
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    with torch.cuda.device(boxes.device):
        status = fn(*[f.data_ptr() for f in feats], hw, boxes.data_ptr(), out.data_ptr(),
                    b, r, c, ph, pw, scale, LN2, stream)
    cuda_build.check(status, "roi_align")
    launches += 1
    return out


def bf16_tolerance(features: Sequence[torch.Tensor]) -> float:
    """Stated bound on |kernel - plain| in bf16.

    The plain version rounds to bf16 after each of its 4 products and 3 sums;
    the kernel rounds once. Each rounding is within 2^-8 relative, and every
    partial sum is bounded by the largest corner value M (the weights sum to
    1 up to their own rounding), so the gap is below 8 roundings of M:
    8 · 2^-8 · M = 2^-5 · M.
    """
    m = max(float(f.detach().abs().max()) for f in features)
    return math.ldexp(m, -5)
