"""Multilevel ROIAlign (crop_and_resize): plain PyTorch version and CUDA kernels.

Port of ``objectdetection_tpu.ops.roi_align`` (``crop_and_resize``,
``roi_levels``, ``batched_multilevel_roi_align``) and of the Pallas kernel
``objectdetection_tpu/ops/roi_align_pallas.py`` ``_kernel``, whose CUDA
counterpart is ``csrc/roi_align.cu``. The same source holds the gradient with
respect to the pyramid, a kernel of its own (the JAX package leaves it to
XLA's autodiff of the four-gather sum); the boxes get no gradient, as
``jax.lax.stop_gradient(boxes)`` gives.

Bilinear semantics follow ``tf.image.crop_and_resize(method="bilinear")``:
for an output grid of size P, sample i of a box lies at
``y1*(H-1) + i*((y2-y1)*(H-1)/(P-1))`` on the box's pyramid level (boxes in
normalized, corner-aligned coordinates). Each box's level comes from the FPN
assignment rule; zero-area boxes pin to the finest level.

:func:`batched_multilevel_roi_align` launches the kernel for CUDA features
(through an autograd Function whose backward launches the gradient kernel)
and runs :func:`batched_multilevel_roi_align_plain`, which autograd
differentiates, for CPU features.

The int8 serving path adds two epilogues, as the Pallas kernel takes them
(``out_quant`` and ``in_scale``, roi_align_pallas.py:315-338, 693-711):

- ``out_quant``, a [ph, pw, C] scale map: the output is int8, each value
  quantized as ``quantize_act`` does (``round(v · 127·inv(s))``, clipped).
  A float input is blended exactly as the float path blends it (in bf16,
  rounded after every operation as PyTorch and XLA round), so its codes are
  those of ``quantize_act`` of the float path's pooled tensor, bit for bit;
- ``in_scale`` (scalar or [C]): the levels are int8 codes with that scale;
  the bilinear blend runs on the raw codes in f32 with f32 weights, and the
  s_in/127 dequant moves into the epilogue map (alone: a bf16 output).

Both variants are inference only. The kernel and the plain version compute
the same f32 operations in the same order, so they are bit-equal; zero boxes
need no fill, as they sample the P2 corner, which the map quantizes as the
Pallas kernel's zero-row fill does (roi_align_pallas.py:809-830). A NaN
value quantizes to code 0, as XLA converts NaN to an integer.

Samples outside the map read what JAX's gather reads (the kernels too):
``floor(coord)`` converts as XLA converts (NaN → 0, saturated to int32), the
lower corner ``i1 = min(i0 + 1, size - 1)`` is not clipped below, the table
index ``row0 + y·W + x`` is int32 arithmetic that wraps, and ``jnp.take``
wraps a negative index once by the table's length and reads NaN for what is
still outside (its gradient drops those). So a sample more than a pixel
above or left of its map reads a row of the previous image or level, or,
for image 0 at P2, of the end of the table.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from objectdetection_torch.ops import cuda_build

LN2 = float(np.log(np.float32(2.0)).astype(np.float32))
_MAX_POOL = 32
_NO_LAYOUT = -1  # csrc/roi_align.cu NO_LAYOUT
# footprint pixels a block of the gradient kernel may sum in shared memory
# (csrc/roi_align.cu SHARED_PIXELS)
SHARED_PIXELS = 512


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
    lvl = _wrap32(canonical_level + xla_to_int32(torch.round(log2)))
    lvl = torch.where(area > 0, lvl, torch.full_like(lvl, min_level))
    return torch.clamp(lvl, min_level, max_level)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as int32 arithmetic that wraps (XLA's) leaves them."""
    return torch.remainder(x + 2**31, 2**32) - 2**31


def xla_to_int32(f: torch.Tensor) -> torch.Tensor:
    """XLA's f32 → s32 convert (``astype(int32)``), as int64: truncation,
    NaN → 0, saturated to [-2^31, 2^31 - 1] (torch's own cast is undefined
    there)."""
    f = torch.where(torch.isnan(f), torch.zeros_like(f), f)
    return torch.clamp(f.clamp(-2.0**31, 2.0**31).to(torch.int64), max=2**31 - 1)


def _bilinear_weights_1d(coord: torch.Tensor, size: torch.Tensor):
    i0 = torch.floor(coord)
    w1 = coord - i0
    i0 = xla_to_int32(i0)
    i1 = torch.minimum(_wrap32(i0 + 1), size - 1)  # not clipped below, as in JAX
    i0 = torch.minimum(torch.clamp(i0, min=0), size - 1)
    return i0, i1, w1


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor, crop_size) -> torch.Tensor:
    """Bilinear crop from one map: [..., H, W, C] × [..., R, 4] → [..., R, ph, pw, C].

    Single-level ``tf.image.crop_and_resize`` (normalized corner-aligned
    boxes), leading dims shared by image and boxes. Sample points outside the
    map are 0, which matters for boxes beyond [0, 1] (mini-mask crops).
    """
    *lead, h, w, c = image.shape
    r = boxes.shape[-2]
    ph, pw = crop_size
    y1, x1, y2, x2 = boxes.to(torch.float32).unbind(-1)

    def grid(p, lo, hi, size):
        steps = torch.arange(p, dtype=torch.float32, device=boxes.device)
        sm1 = _f32(size - 1, boxes)
        if p > 1:
            return lo[..., None] * sm1 + steps * ((hi - lo)[..., None] * sm1 / _f32(p - 1, boxes))
        return 0.5 * (lo + hi)[..., None] * sm1

    ys = grid(ph, y1, y2, h)  # [..., R, ph]
    xs = grid(pw, x1, x2, w)  # [..., R, pw]
    size_h = torch.tensor(h, device=boxes.device)
    size_w = torch.tensor(w, device=boxes.device)
    y0i, y1i, wy = _bilinear_weights_1d(ys, size_h)
    x0i, x1i, wx = _bilinear_weights_1d(xs, size_w)
    flat = image.reshape(*lead, h * w, c)

    def take(yi, xi):
        # samples outside the map read a clamped row and are zeroed below
        yi, xi = yi.clamp(0, h - 1), xi.clamp(0, w - 1)
        idx = (yi[..., :, None] * w + xi[..., None, :]).reshape(*lead, r * ph * pw, 1)
        return torch.gather(flat, -2, idx.expand(*lead, r * ph * pw, c)).reshape(
            *lead, r, ph, pw, c)

    wx_, wy_ = wx[..., None, :, None], wy[..., :, None, None]
    top = take(y0i, x0i) * (1 - wx_) + take(y0i, x1i) * wx_
    bot = take(y1i, x0i) * (1 - wx_) + take(y1i, x1i) * wx_
    out = top * (1 - wy_) + bot * wy_
    inside = (((ys >= 0) & (ys <= h - 1))[..., :, None]
              & ((xs >= 0) & (xs <= w - 1))[..., None, :])
    return torch.where(inside[..., None], out, torch.zeros_like(out))


def _corners(level_hw, boxes, image_shape, crop_size):
    """Bilinear corners of every sample: four (flat-table rows [N], f32
    weights [N]) pairs, N = B·R·ph·pw, for levels of the given (H, W) whose
    [B, H, W, C] maps are flattened and concatenated level after level. A
    row is JAX's index after ``jnp.take`` wrapped it (module doc), or -1
    where it lies outside the table (JAX reads NaN there; from indices
    clipped to ``size - 1`` that takes int32 wrap-around of a saturated
    coordinate)."""
    b, r = boxes.shape[:2]
    ph, pw = crop_size
    dev = boxes.device
    heights = torch.tensor([h for h, _ in level_hw], device=dev)
    widths = torch.tensor([w for _, w in level_hw], device=dev)
    sizes = heights * widths
    level_base = torch.cumsum(sizes * b, 0) - sizes * b
    table = int(sizes.sum()) * b

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
        t = _wrap32(row0[..., None, None] + yi[..., :, None] * lw[..., None, None]
                    + xi[..., None, :]).reshape(-1)
        t = torch.where(t < 0, t + table, t)
        return torch.where((t >= 0) & (t < table), t, torch.full_like(t, -1))

    def wprod(a, b_):
        return (a[..., :, None] * b_[..., None, :]).reshape(n)

    return [
        (flat_idx(y0i, x0i), wprod(1 - wy, 1 - wx)),
        (flat_idx(y0i, x1i), wprod(1 - wy, wx)),
        (flat_idx(y1i, x0i), wprod(wy, 1 - wx)),
        (flat_idx(y1i, x1i), wprod(wy, wx)),
    ]


def touched_row_marks(feature_shapes, boxes, image_shape, crop_size) -> torch.Tensor:
    """Plain version of the gradient kernels' row marks: a bool per row of
    the levels' flat table, set where some sample's bilinear corner lands
    (zero weights included; nothing for corners outside the table). The bf16
    gradient zeroes its f32 sums on these rows only and writes every other
    row as zero, so they must hold every row the gradient reaches."""
    shapes = [tuple(sh) for sh in feature_shapes]
    corners = _corners([sh[1:3] for sh in shapes], boxes, image_shape, crop_size)
    marks = torch.zeros(sum(sh[0] * sh[1] * sh[2] for sh in shapes), dtype=torch.bool,
                        device=boxes.device)
    for rows, _ in corners:
        marks[rows[rows >= 0]] = True
    return marks


def touched_rows(features: Sequence[torch.Tensor], boxes, image_shape, crop_size) -> int:
    """Distinct feature rows (C values each) that the samples of `boxes` need:
    corners with a nonzero bilinear weight."""
    corners = _corners([f.shape[1:3] for f in features], boxes, image_shape, crop_size)
    rows = torch.cat([rows[(w != 0) & (rows >= 0)] for rows, w in corners])
    return int(torch.unique(rows).numel())


def epilogue_map(out_quant, in_scale, crop_size, channels: int, device) -> torch.Tensor:
    """The f32 [ph, pw, C] multiplier of the int8 epilogues: 127·inv(s_out)
    (``quantize_act``'s formula) for ``out_quant``, times s_in/127 for int8
    input."""
    ph, pw = crop_size
    m = None
    if out_quant is not None:
        s = out_quant.to(device=device, dtype=torch.float32).expand(ph, pw, channels)
        inv = torch.where(s > 0, _f32(1.0, s) / torch.clamp(s, min=1e-30), torch.zeros_like(s))
        m = inv * 127.0
    if in_scale is not None:
        s_in = in_scale.to(device=device, dtype=torch.float32).reshape(-1).expand(channels)
        d = s_in / _f32(127.0, s_in)
        m = d.expand(ph, pw, channels) if m is None else m * d
    return m.contiguous()


def batched_multilevel_roi_align_plain(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    image_shape: Tuple[int, int],
    crop_size: Tuple[int, int],
    out_quant=None,
    in_scale=None,
) -> torch.Tensor:
    """features: P2..P5, each [B, H_l, W_l, C]; boxes [B, R, 4] → [B, R, ph, pw, C].

    The four-gather form of ``roi_align.batched_multilevel_roi_align``: every
    level flattens into one [Σ B·H_l·W_l, C] table and each bilinear corner is
    one row gather; the weighted sum runs in the feature dtype (f32 for int8
    codes). ``out_quant`` / ``in_scale``: the int8 epilogues (module doc).
    """
    features = list(features)
    if out_quant is not None or in_scale is not None:
        if (in_scale is not None) != (features[0].dtype == torch.int8):
            raise ValueError("roi_align: int8 levels go with in_scale, and only they")
        if in_scale is not None:
            features = [f.to(torch.float32) for f in features]
        v = batched_multilevel_roi_align_plain(features, boxes, image_shape, crop_size)
        m = epilogue_map(out_quant, in_scale, crop_size, v.shape[-1], v.device)
        if out_quant is None:
            return (v * m).to(torch.bfloat16)
        q = torch.clamp(torch.round(v.to(torch.float32) * m), -128.0, 127.0)
        return torch.where(torch.isnan(q), torch.zeros_like(q), q).to(torch.int8)
    b, r = boxes.shape[:2]
    c = features[0].shape[-1]
    flat = torch.cat([f.reshape(-1, c) for f in features], dim=0)
    dtype = flat.dtype
    corners = _corners([f.shape[1:3] for f in features], boxes, image_shape, crop_size)

    def take(rows):  # jnp.take's fill: NaN outside the table, no gradient there
        got = flat[rows.clamp(min=0)]
        return torch.where((rows >= 0)[:, None], got, torch.full_like(got, math.nan))

    (r00, w00), (r01, w01), (r10, w10), (r11, w11) = corners
    out = (
        take(r00) * w00[:, None].to(dtype)
        + take(r01) * w01[:, None].to(dtype)
        + take(r10) * w10[:, None].to(dtype)
        + take(r11) * w11[:, None].to(dtype)
    )
    return out.reshape(b, r, *crop_size, c)


def _check_pyramid(shapes, dtypes, devices, boxes, crop_size):
    """Raise on what the kernels do not take: 1 to 4 levels [B, H_l, W_l, C]
    of one dtype (f32 or bf16) on the boxes' device, boxes [B, R, 4], crop
    <= 32."""
    if not 1 <= len(shapes) <= 4:
        raise ValueError("roi_align kernel: expects 1 to 4 levels (P2..P5, or one map)")
    dtype = dtypes[0]
    if dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"roi_align kernel: unsupported dtype {dtype}")
    b, r, four = boxes.shape
    c = shapes[0][-1]
    for shape, dt, dev in zip(shapes, dtypes, devices):
        if len(shape) != 4 or dt != dtype or shape[0] != b or shape[-1] != c or dev != boxes.device:
            raise ValueError("roi_align kernel: levels disagree in dtype, batch, channels or device")
    ph, pw = crop_size
    if four != 4 or not (1 <= ph <= _MAX_POOL and 1 <= pw <= _MAX_POOL):
        raise ValueError(f"roi_align kernel: bad boxes {boxes.shape} or crop {crop_size}")
    if sum(s[0] * s[1] * s[2] for s in shapes) >= 2**31:
        raise ValueError("roi_align kernel: the pyramid's rows overflow JAX's int32 table index")


def _no_layout(what: str, channels: int, dtype):
    """A forward launch's own status check. The kernel gives each of its 256
    threads a 16-byte channel vector where the channels fill whole vectors
    of 16-byte-aligned tensors, else one channel: it returns NO_LAYOUT for
    more channels than either layout takes."""
    def check(status: int) -> None:
        if status == _NO_LAYOUT:
            raise ValueError(f"{what} kernel: {channels} channels of {dtype} fill no thread "
                             "layout")
    return check


# the forward kernels (f32, bf16 and the int8 epilogues) and the gradient's
_LEVELS = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)]
_SCALES = [ctypes.c_float, ctypes.c_float]
_FORWARD = {dtype: cuda_build.Entry("roi_align", f"roi_align_{kind}", _LEVELS + [
    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + _SCALES, name="roi_align")
    for dtype, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))}
_QUANT = cuda_build.Entry("roi_align", "roi_align_quant", _LEVELS + [ctypes.c_void_p] * 3 + [
    ctypes.c_int] * 7 + _SCALES, name="roi_align_int8")
_BACKWARD = {dtype: cuda_build.Entry("roi_align", f"roi_align_backward_{kind}", [
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)] + [ctypes.c_void_p] * 7 + [
    ctypes.c_int] * 5 + _SCALES, name="roi_align_backward")
    for dtype, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))}


def _level_dims(shapes):
    """(h, w) of each level, zeros for the levels after the last given: the
    kernels pick among the given ones."""
    dims = [d for shape in shapes for d in shape[1:3]]
    return (ctypes.c_int * 8)(*dims, *[0] * (8 - len(dims)))


def _level_ptrs(tensors):
    """The levels' data pointers, the first repeated where fewer than 4 are
    given (an empty level is never read)."""
    ptrs = [t.data_ptr() for t in tensors]
    return ptrs + ptrs[:1] * (4 - len(ptrs))


def _forward_kernel(features, boxes, image_shape, crop_size) -> torch.Tensor:
    _check_pyramid([f.shape for f in features], [f.dtype for f in features],
                   [f.device for f in features], boxes, crop_size)
    dtype = features[0].dtype
    if dtype == torch.int8:
        raise ValueError("roi_align: int8 levels need their in_scale")
    b, r = boxes.shape[:2]
    c = features[0].shape[-1]
    ph, pw = crop_size
    feats = [f.contiguous() for f in features]  # NHWC rows, channel fastest
    boxes = boxes.to(torch.float32).contiguous()
    out = torch.empty((b, r, ph, pw, c), dtype=dtype, device=boxes.device)
    if b == 0 or r == 0:
        return out
    scale = _canonical_scale(float(image_shape[0] * image_shape[1]))
    _FORWARD[dtype].launch(boxes.device, *_level_ptrs(feats),
                           _level_dims([f.shape for f in feats]), boxes.data_ptr(),
                           out.data_ptr(), b, r, c, ph, pw, scale, LN2,
                           on_status=_no_layout("roi_align", c, dtype))
    return out


_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _quant_kernel(features, boxes, image_shape, crop_size, out_quant, in_scale) -> torch.Tensor:
    """The int8-epilogue variants on the card (inference: no gradient)."""
    _check_pyramid([f.shape for f in features], [f.dtype for f in features],
                   [f.device for f in features], boxes, crop_size)
    dtype = features[0].dtype
    if (in_scale is not None) != (dtype == torch.int8):
        raise ValueError("roi_align: int8 levels go with in_scale, and only they")
    b, r = boxes.shape[:2]
    c = features[0].shape[-1]
    ph, pw = crop_size
    feats = [f.contiguous() for f in features]
    boxes = boxes.to(torch.float32).contiguous()
    m = epilogue_map(out_quant, in_scale, crop_size, c, boxes.device)
    out_dtype = torch.int8 if out_quant is not None else torch.bfloat16
    out = torch.empty((b, r, ph, pw, c), dtype=out_dtype, device=boxes.device)
    if b == 0 or r == 0:
        return out
    scale = _canonical_scale(float(image_shape[0] * image_shape[1]))
    _QUANT.launch(boxes.device, *_level_ptrs(feats),
                  _level_dims([f.shape for f in feats]), boxes.data_ptr(), m.data_ptr(),
                  out.data_ptr(), _KINDS[dtype], _KINDS[out_dtype], b, r, c, ph, pw, scale, LN2,
                  on_status=_no_layout("roi_align_quant", c, dtype))
    return out


def roi_align_backward(
    grad_out: torch.Tensor,
    boxes: torch.Tensor,
    feature_shapes: Sequence[Tuple[int, ...]],
    image_shape: Tuple[int, int],
) -> List[torch.Tensor]:
    """Gradient of :func:`batched_multilevel_roi_align` with respect to
    P2..P5, by the CUDA kernels: grad_out [B, R, ph, pw, C] (f32 or bf16) →
    four [B, H_l, W_l, C] tensors in grad_out's dtype. The kernels sum in f32;
    a bf16 result is rounded once from that sum. A CPU grad_out takes
    :func:`roi_align_backward_plain`."""
    if not cuda_build.takes_kernel(grad_out, "roi_align_backward"):
        return roi_align_backward_plain(grad_out, boxes, feature_shapes, image_shape)
    return _backward_kernel(grad_out, boxes, feature_shapes, image_shape)[0]


def _backward_kernel(grad_out, boxes, feature_shapes, image_shape):
    """:func:`roi_align_backward`, and for bf16 the kernels' row marks (one
    byte per row of the levels' flat table; None in f32)."""
    dtype = grad_out.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align_backward kernel: unsupported dtype {dtype}")
    b, r, ph, pw, c = grad_out.shape
    shapes = [tuple(s) for s in feature_shapes]
    dev = grad_out.device
    _check_pyramid(shapes, [dtype] * len(shapes), [dev] * len(shapes), boxes, (ph, pw))
    if any(s[-1] != c for s in shapes):
        raise ValueError(f"roi_align_backward: grad_out channels {c} != levels' {shapes}")
    if b == 0 or r == 0:
        return [torch.zeros(s, dtype=dtype, device=dev) for s in shapes], None
    grads = [torch.empty(s, dtype=dtype, device=dev) for s in shapes]  # written whole
    scratch = marks = None
    if dtype == torch.bfloat16:  # the f32 sums of the rows the ROIs reach, and their marks
        rows = sum(s[0] * s[1] * s[2] for s in shapes)
        scratch = torch.empty((rows, c), dtype=torch.float32, device=dev)
        marks = torch.empty(rows, dtype=torch.uint8, device=dev)
    g_out = grad_out.contiguous()
    boxes = boxes.to(torch.float32).contiguous()
    scale = _canonical_scale(float(image_shape[0] * image_shape[1]))
    _BACKWARD[dtype].launch(dev, g_out.data_ptr(), _level_dims(shapes), boxes.data_ptr(),
                            *_level_ptrs(grads),
                            None if scratch is None else scratch.data_ptr(),
                            None if marks is None else marks.data_ptr(),
                            b, r, c, ph, pw, scale, LN2)
    return grads, marks


def roi_align_backward_plain(
    grad_out: torch.Tensor,
    boxes: torch.Tensor,
    feature_shapes: Sequence[Tuple[int, ...]],
    image_shape: Tuple[int, int],
) -> List[torch.Tensor]:
    """Plain version of :func:`roi_align_backward`: autograd of
    :func:`batched_multilevel_roi_align_plain` (the result does not depend on
    the feature values, so zeros of the right shapes stand in for them)."""
    crop = tuple(grad_out.shape[2:4])
    with torch.enable_grad():
        feats = [torch.zeros(s, dtype=grad_out.dtype, device=grad_out.device,
                             requires_grad=True) for s in feature_shapes]
        out = batched_multilevel_roi_align_plain(feats, boxes, image_shape, crop)
        return list(torch.autograd.grad(out, feats, grad_out))


class _RoIAlign(torch.autograd.Function):
    """The forward kernel, differentiable in the features by the backward
    kernel; the boxes get no gradient."""

    @staticmethod
    def forward(ctx, boxes, image_shape, crop_size, *features):
        ctx.save_for_backward(boxes)
        ctx.shapes = [f.shape for f in features]
        ctx.image_shape = image_shape
        return _forward_kernel(list(features), boxes, image_shape, crop_size)

    @staticmethod
    def backward(ctx, grad_out):
        (boxes,) = ctx.saved_tensors
        grads = roi_align_backward(grad_out, boxes, ctx.shapes, ctx.image_shape)
        return (None, None, None, *grads)


def batched_multilevel_roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    image_shape: Tuple[int, int],
    crop_size: Tuple[int, int],
    out_quant=None,
    in_scale=None,
) -> torch.Tensor:
    """Pyramid ROIAlign: P2..P5 [B, H_l, W_l, C] (f32 or bf16) × boxes
    [B, R, 4] f32 → [B, R, ph, pw, C] in the feature dtype. Differentiable in
    the features on every device (never in the boxes).

    Fewer levels (one map alone, say) are the pyramid's first ones: a box
    whose rule names a later level takes the last given (with one map,
    every box pools it).

    ``out_quant`` [ph, pw, C] scales → int8 output; ``in_scale`` (scalar or
    [C]) with int8 levels → the blend of the codes, dequantized (bf16
    output) or requantized with ``out_quant``. See the module doc."""
    features = list(features)
    if not cuda_build.takes_kernel(features[0], "roi_align"):
        return batched_multilevel_roi_align_plain(features, boxes.detach(), image_shape,
                                                  crop_size, out_quant, in_scale)
    if out_quant is not None or in_scale is not None:
        return _quant_kernel(features, boxes.detach(), tuple(image_shape), tuple(crop_size),
                             out_quant, in_scale)
    return _RoIAlign.apply(boxes.detach(), tuple(image_shape), tuple(crop_size), *features)


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


def _gamma(k: torch.Tensor, u: float) -> torch.Tensor:
    """Higham's bound k·u / (1 - k·u) on the relative error of a k-term float
    sum (inf where k·u >= 1)."""
    ku = k.to(torch.float64) * u
    return torch.where(ku < 1, ku / (1 - ku), torch.full_like(ku, math.inf))


def backward_tolerance(
    grad_out: torch.Tensor,
    boxes: torch.Tensor,
    feature_shapes: Sequence[Tuple[int, ...]],
    image_shape: Tuple[int, int],
    against_f32: bool = False,
) -> List[torch.Tensor]:
    """Stated elementwise bound on the gradient kernel's error, per level.

    Every gradient element is a sum of n products g·w (n: the samples whose
    nonzero-weight corner lands on its row) whose absolute sum is S (the
    plain backward of |grad_out| in f64). Both sides form the same exact sum
    with the same weights (rounded to the feature type):

    - against :func:`roi_align_backward_plain` (``against_f32=False``): the
      kernel sums in f32 and rounds once; the plain version rounds each
      product and accumulates in the feature type, four corner groups then
      added, so |kernel - plain| <= γ(n + 6, u)·S with u = 2^-8 in bf16 and
      2·γ(n + 4, 2^-24)·S in f32;
    - against the plain backward run in f32 on the same grad_out, with f32
      weights (``against_f32=True``, meaningful for bf16): the weights differ
      by one bf16 rounding and the kernel's result by one more, so
      |kernel - ref| <= (2^-7 + γ(2n + 8, 2^-24))·S.
    """
    shapes = [tuple(sh) for sh in feature_shapes]
    crop = tuple(grad_out.shape[2:4])
    s_abs = roi_align_backward_plain(grad_out.detach().abs().to(torch.float64), boxes, shapes,
                                     image_shape)
    corners = _corners([sh[1:3] for sh in shapes], boxes, image_shape, crop)
    rows = sum(sh[0] * sh[1] * sh[2] for sh in shapes)
    count = torch.zeros(rows, dtype=torch.int64, device=boxes.device)
    for r, w in corners:
        hit = r[(w != 0) & (r >= 0)]
        count.index_add_(0, hit, torch.ones_like(hit))
    if against_f32:
        gamma = 2.0 ** -7 + _gamma(2 * count + 8, 2.0 ** -24)
    elif grad_out.dtype == torch.bfloat16:
        gamma = _gamma(count + 6, 2.0 ** -8)
    else:
        gamma = 2 * _gamma(count + 4, 2.0 ** -24)
    out, start = [], 0
    for sh, s in zip(shapes, s_abs):
        n = sh[0] * sh[1] * sh[2]
        # where S = 0 every product is zero on both sides: the bound is 0,
        # also where γ has no value (inf · 0)
        out.append((gamma[start:start + n].reshape(*sh[:3], 1) * s).masked_fill(s == 0, 0.0))
        start += n
    return out
