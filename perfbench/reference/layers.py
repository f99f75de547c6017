"""Plain building blocks of the reference: convolutions, anchors, box
arithmetic, greedy NMS and pyramid ROIAlign, in float32.

Conventions (those of the program under test, so that a correct program
agrees with the reference up to its own precision):

- convolutions pad as flax's ``"SAME"`` (the odd row and column at the high
  end) unless given explicit pads; BatchNorm is frozen, eps 1e-3;
- boxes are normalized ``(y1, x1, y2, x2)``; anchors are normalized by
  ``(h - 1, w - 1)`` with the far corner shifted by one pixel;
- NMS is greedy in descending score (ties to the lower index), a box
  suppresses a later one of the same class whose IoU exceeds the threshold,
  and an all-zero row neither survives nor suppresses;
- ROIAlign is ``tf.image.crop_and_resize`` (corner-aligned samples) on the
  FPN level of eq. 1 of the FPN paper (k0 = 4, canonical 224 pixels), with
  sample indices computed as 32-bit integers and rows outside the flattened
  table read as NaN (the behaviour of the gather the program reproduces).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LN2 = float(np.log(np.float32(2.0)).astype(np.float32))
BN_EPS = 1e-3


class Precision:
    """How the layers that the program runs below float32 are computed.

    ``mode``: ``"f32"`` (the reference), ``"int4"`` (the control of an
    int8 program: weights rounded to 4 bits per output channel by their
    absmax, activations per input channel by their absmax, or by the
    scales :meth:`calibrate` recorded) or ``"fp8"`` (the control of a bf16
    program: weights and activations rounded to float8 e4m3 with a
    per-tensor scale). Only layers marked ``low`` are affected; the mark
    follows the program's own split (its float heads stay float).

    Calibration mirrors an int8 recipe's: between :meth:`calibrate` and
    :meth:`freeze` the forward runs in float32 and each low layer's input
    records its per-channel absmax a chunk; each scale becomes the given
    percentile over the chunks. Layers are told apart by their order in a
    forward, which :meth:`begin` restarts.
    """

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "int4", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.scales: dict = {}
        self._seen: Optional[dict] = None
        self._k = 0

    def begin(self) -> None:
        self._k = 0

    def calibrate(self) -> None:
        self._seen = {}

    def freeze(self, percentile: float) -> None:
        self.scales = {k: torch.quantile(torch.stack(v), percentile / 100.0, dim=0)
                       for k, v in self._seen.items()}
        self._seen = None

    def weight(self, w: torch.Tensor, low: bool) -> torch.Tensor:
        if not low or self.mode == "f32" or self._seen is not None:
            return w
        if self.mode == "int4":
            dims = tuple(range(1, w.dim()))
            s = w.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / 7.0
            return torch.clamp(torch.round(w / s), -7, 7) * s
        return _fp8(w)

    def act(self, x: torch.Tensor, low: bool, channel_dim: int = 1) -> torch.Tensor:
        if not low or self.mode == "f32":
            return x
        if self.mode == "fp8":
            return _fp8(x)
        k, self._k = self._k, self._k + 1
        dims = tuple(d for d in range(x.dim()) if d != channel_dim % x.dim())
        absmax = x.abs().amax(dim=dims, keepdim=True)
        if self._seen is not None:
            self._seen.setdefault(k, []).append(absmax.reshape(-1))
            return x
        if k in self.scales:
            shape = [1] * x.dim()
            shape[channel_dim % x.dim()] = -1
            absmax = self.scales[k].view(shape)
        s = absmax.clamp(min=1e-30) / 7.0
        return torch.clamp(torch.round(x / s), -7, 7) * s


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with a per-tensor scale that maps the absmax to
    the format's largest finite value (448)."""
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


F32 = Precision("f32")


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
         pads: Optional[Tuple[int, int, int, int]] = None, prec: Precision = F32,
         low: bool = False, weight_only: bool = False) -> torch.Tensor:
    """NCHW conv with SAME padding, or ``pads`` (top, bottom, left, right)."""
    k = w.shape[-1]
    if pads is None:
        pads = (*same_pads(x.shape[2], k, stride), *same_pads(x.shape[3], k, stride))
    t, bo, l, r = pads
    if (t, bo, l, r) != (0, 0, 0, 0):
        x = F.pad(x, (l, r, t, bo))
    if not weight_only:
        x = prec.act(x, low)
    return F.conv2d(x, prec.weight(w, low), b, stride=stride)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, prec: Precision = F32,
          low: bool = False) -> torch.Tensor:
    """x [..., in] @ w [out, in].T + b."""
    return F.linear(prec.act(x, low, -1), prec.weight(w, low), b)


def frozen_bn(x: torch.Tensor, p: dict, name: str, channel_dim: int = 1) -> torch.Tensor:
    inv = p[name + ".scale"] / torch.sqrt(p[name + ".var"] + BN_EPS)
    shift = p[name + ".bias"] - p[name + ".mean"] * inv
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    return x * inv.view(shape) + shift.view(shape)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    pads = []
    for size in (x.shape[3], x.shape[2]):
        pads += list(same_pads(size, k, s))
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), k, s)


# --------------------------------------------------------------------------
# anchors and boxes


def pyramid_anchors(image_hw: Tuple[int, int], scales: Sequence[float],
                    ratios: Sequence[float], strides: Sequence[int]) -> np.ndarray:
    """Normalized anchors [A, 4] in (level, y, x, ratio) order."""
    h, w = image_hw
    out = []
    for scale, stride in zip(scales, strides):
        fh, fw = -(-h // stride), -(-w // stride)
        r = np.asarray(ratios, dtype=np.float64)
        hs, ws = scale / np.sqrt(r), scale * np.sqrt(r)
        cy = (np.arange(fh) * stride).astype(np.float64)
        cx = (np.arange(fw) * stride).astype(np.float64)
        cy, cx = np.meshgrid(cy, cx, indexing="ij")
        cy, cx = cy[..., None], cx[..., None]
        boxes = np.stack(np.broadcast_arrays(cy - 0.5 * hs, cx - 0.5 * ws,
                                             cy + 0.5 * hs, cx + 0.5 * ws), -1)
        out.append(boxes.reshape(-1, 4))
    pix = np.concatenate(out, 0)
    scale = np.array([h - 1, w - 1, h - 1, w - 1])
    shift = np.array([0, 0, 1, 1])
    return ((pix - shift) / scale).astype(np.float32)


def apply_deltas(boxes: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    cy = boxes[..., 0] + 0.5 * h + d[..., 0] * h
    cx = boxes[..., 1] + 0.5 * w + d[..., 1] * w
    h = h * torch.exp(d[..., 2])
    w = w * torch.exp(d[..., 3])
    y1, x1 = cy - 0.5 * h, cx - 0.5 * w
    return torch.stack([y1, x1, y1 + h, x1 + w], -1)


def clip(boxes: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Clip [..., 4] to window [4] or [..., 4] (broadcast)."""
    wy1, wx1, wy2, wx2 = window.unbind(-1)
    y1 = torch.minimum(torch.maximum(boxes[..., 0], wy1), wy2)
    x1 = torch.minimum(torch.maximum(boxes[..., 1], wx1), wx2)
    y2 = torch.minimum(torch.maximum(boxes[..., 2], wy1), wy2)
    x2 = torch.minimum(torch.maximum(boxes[..., 3], wx1), wx2)
    return torch.stack([y1, x1, y2, x2], -1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, 4] × b [K, 4] → IoU [M, K] (0 where the union is empty)."""
    ih = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp(min=0)
    iw = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp(min=0)
    inter = ih * iw
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = aa[:, None] + ab[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def stable_desc(scores: torch.Tensor) -> torch.Tensor:
    """Indices that sort the last axis descending, ties to the lower index."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def greedy_nms(boxes: torch.Tensor, classes: torch.Tensor, threshold: float,
               max_out: int) -> List[int]:
    """Greedy NMS over score-sorted rows of one image: boxes [N, 4] (zero
    rows are padding), classes [N]. Returns the kept rows, at most
    ``max_out``, in order."""
    lo = torch.minimum(boxes[:, :2], boxes[:, 2:])
    hi = torch.maximum(boxes[:, :2], boxes[:, 2:])
    boxes = torch.cat([lo, hi], -1)
    kills = ((iou(boxes, boxes) > threshold)
             & (classes[:, None] == classes[None, :])).cpu().numpy()
    present = (boxes != 0).any(-1).cpu().numpy()
    alive = present.copy()
    keep: List[int] = []
    for i in range(boxes.shape[0]):
        if not alive[i]:
            continue
        keep.append(i)
        if len(keep) == max_out:
            break
        alive[i + 1:] &= ~kills[i, i + 1:]
    return keep


# --------------------------------------------------------------------------
# pyramid ROIAlign


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + 2**31, 2**32) - 2**31


def _to_int32(f: torch.Tensor) -> torch.Tensor:
    f = torch.where(torch.isnan(f), torch.zeros_like(f), f)
    return torch.clamp(f.clamp(-2.0**31, 2.0**31).to(torch.int64), max=2**31 - 1)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def roi_levels(boxes: torch.Tensor, image_area: float) -> torch.Tensor:
    """FPN level 2..5 of each ROI: k = 4 + round(log2(sqrt(wh) / (224 /
    sqrt(image area)))) for normalized boxes."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    canon = float(np.float32(224.0 / np.sqrt(image_area)))
    scale = torch.sqrt(torch.clamp(area, min=1e-12)) / _f32(canon, boxes)
    lvl = _wrap32(4 + _to_int32(torch.round(torch.log(scale) / _f32(LN2, boxes))))
    lvl = torch.where(area > 0, lvl, torch.full_like(lvl, 2))
    return torch.clamp(lvl, 2, 5)


def corners(level_hw, boxes: torch.Tensor, image_hw, crop) -> list:
    """The four bilinear corners of every sample of ``boxes`` [B, R, 4] on
    levels of sizes ``level_hw`` flattened into one table (level after
    level, image after image): (row [N], weight [N]) each, row -1 outside."""
    b, r = boxes.shape[:2]
    ph, pw = crop
    dev = boxes.device
    heights = torch.tensor([h for h, _ in level_hw], device=dev)
    widths = torch.tensor([w for _, w in level_hw], device=dev)
    sizes = heights * widths
    base = torch.cumsum(sizes * b, 0) - sizes * b
    table = int(sizes.sum()) * b
    boxes = boxes.to(torch.float32)
    li = roi_levels(boxes, float(image_hw[0] * image_hw[1])) - 2
    lh, lw = heights[li], widths[li]
    row0 = base[li] + torch.arange(b, device=dev)[:, None] * sizes[li]
    y1, x1, y2, x2 = boxes.unbind(-1)

    def grid(p, lo, hi, size):
        steps = torch.arange(p, dtype=torch.float32, device=dev)
        sf = size.to(torch.float32)[..., None]
        if p > 1:
            return lo[..., None] * (sf - 1) + steps * ((hi - lo)[..., None] * (sf - 1)
                                                       / _f32(p - 1, boxes))
        return 0.5 * (lo + hi)[..., None] * (sf - 1)

    def weights_1d(coord, size):
        i0 = torch.floor(coord)
        frac = coord - i0
        i0 = _to_int32(i0)
        i1 = torch.minimum(_wrap32(i0 + 1), size - 1)
        i0 = torch.minimum(torch.clamp(i0, min=0), size - 1)
        return i0, i1, frac

    y0i, y1i, wy = weights_1d(grid(ph, y1, y2, lh), lh[..., None])
    x0i, x1i, wx = weights_1d(grid(pw, x1, x2, lw), lw[..., None])
    n = b * r * ph * pw

    def flat(yi, xi):
        t = _wrap32(row0[..., None, None] + yi[..., :, None] * lw[..., None, None]
                    + xi[..., None, :]).reshape(-1)
        t = torch.where(t < 0, t + table, t)
        return torch.where((t >= 0) & (t < table), t, torch.full_like(t, -1))

    def prod(a, c):
        return (a[..., :, None] * c[..., None, :]).reshape(n)

    return [(flat(y0i, x0i), prod(1 - wy, 1 - wx)), (flat(y0i, x1i), prod(1 - wy, wx)),
            (flat(y1i, x0i), prod(wy, 1 - wx)), (flat(y1i, x1i), prod(wy, wx))]


def roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor, image_hw,
              crop) -> torch.Tensor:
    """P2..P5 NHWC [B, H_l, W_l, C] × boxes [B, R, 4] → [B, R, ph, pw, C]."""
    b, r = boxes.shape[:2]
    c = feats[0].shape[-1]
    table = torch.cat([f.reshape(-1, c) for f in feats], 0)
    out = None
    for rows, w in corners([f.shape[1:3] for f in feats], boxes, image_hw, crop):
        got = table[rows.clamp(min=0)]
        got = torch.where((rows >= 0)[:, None], got, torch.full_like(got, math.nan))
        term = got * w[:, None]
        out = term if out is None else out + term
    return out.reshape(b, r, *crop, c)
