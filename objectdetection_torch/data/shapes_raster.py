"""Batch rasterizer of the synthetic shapes dataset, in numpy.

Port of the JAX package's native rasterizer
(``objectdetection_tpu/native/shapes_raster.cpp``), whose batches the JAX
``ShapesDataset.load_batch`` returns whenever that library builds. Same
geometry, in the same f32 arithmetic, so that the batches are bit-equal:

- square: the filled rectangle [cy ± s, cx ± s], clipped to the canvas;
- circle: one span a row, ``ceil(cx − √(s² − dy²))`` to
  ``floor(cx + √(s² − dy²))``;
- triangle: vertices (cx, cy − s), (cx ∓ s/sin 60°, cy + s); a pixel of the
  bounding rows ``int(cy − s)``..``int(cy + s)`` and columns
  ``floor(x1)``..``ceil(x2)`` is inside when its three barycentric signs do
  not disagree.

The native library is built with ``-O3 -march=native``, and on a CPU with
FMA the compiler contracts ``cx ∓ s·(1/sin 60°)`` and the first product of
each sign test ``a·b − c·d`` into fused multiply-adds: one rounding where
plain f32 code rounds twice. At the apex that decides a pixel: plain f32
gives the sign 0 there (inside), the fused form the product's rounding
error (outside). The port computes those expressions in f64, exact before
the one rounding to f32, which is the fused result (the signs read only the
sign, which f64's rounding keeps).

Later instances paint over earlier ones and erase them from the earlier
masks (occlusion). Boxes are tight on the visible mask, normalized by
(h − 1, w − 1) with the reference's [0, 0, 1, 1] shift, and fully occluded
instances are dropped, the survivors moved up.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_F32 = np.float32
INV_SIN60 = _F32(1.1547005383792517)  # 1 / sin(60°), as the C++ rounds it to f32


def _sign(ax, ay, bx, by, cx, cy):
    """The sign of (a − c) × (b − c)'s z component as the native build
    computes it, ``fma(ax − cx, by − cy, −f32((bx − cx)·(ay − cy)))``: the
    differences and the second product in f32, the first product exact."""
    first = (ax - cx).astype(np.float64) * (by - cy)
    return first - ((bx - cx) * (ay - cy)).astype(np.float64)


def _fused(cx: int, s: int, sign: int) -> np.float32:
    """f32(cx + sign·s·(1/sin 60°)) rounded once, as an FMA does."""
    return _F32(np.float64(cx) + sign * (np.float64(s) * np.float64(INV_SIN60)))


def raster_instance(h: int, w: int, cls: int, cy: int, cx: int, s: int) -> np.ndarray:
    """The pixels one shape covers: bool [h, w]. ``cls`` 1 square, 2 circle,
    3 triangle."""
    hit = np.zeros((h, w), bool)
    if cls == 1:
        y1, y2 = max(cy - s, 0), min(cy + s, h - 1)
        x1, x2 = max(cx - s, 0), min(cx + s, w - 1)
        if y2 >= y1 and x2 >= x1:
            hit[y1:y2 + 1, x1:x2 + 1] = True
    elif cls == 2:
        y1, y2 = max(cy - s, 0), min(cy + s, h - 1)
        if y2 < y1:
            return hit
        ys = np.arange(y1, y2 + 1)
        dy = (ys - cy).astype(_F32)
        ss = _F32(s) * _F32(s)
        span = np.sqrt(np.maximum(ss - dy * dy, _F32(0)))
        lo = np.maximum(np.ceil(_F32(cx) - span).astype(np.int64), 0)
        hi = np.minimum(np.floor(_F32(cx) + span).astype(np.int64), w - 1)
        cols = np.arange(w)
        hit[y1:y2 + 1] = (cols[None, :] >= lo[:, None]) & (cols[None, :] <= hi[:, None])
    elif cls == 3:
        x0, y0 = _F32(cx), _F32(cy - s)
        x1, y1 = _fused(cx, s, -1), _F32(cy + s)
        x2, y2 = _fused(cx, s, 1), _F32(cy + s)
        ylo, yhi = max(int(y0), 0), min(int(y1), h - 1)  # C++ int(): truncation
        xlo, xhi = max(int(np.floor(x1)), 0), min(int(np.ceil(x2)), w - 1)
        if yhi < ylo or xhi < xlo:
            return hit
        py = np.arange(ylo, yhi + 1).astype(_F32)[:, None]
        px = np.arange(xlo, xhi + 1).astype(_F32)[None, :]
        d0 = _sign(px, py, x0, y0, x1, y1)
        d1 = _sign(px, py, x1, y1, x2, y2)
        d2 = _sign(px, py, x2, y2, x0, y0)
        neg = (d0 < 0) | (d1 < 0) | (d2 < 0)
        pos = (d0 > 0) | (d1 > 0) | (d2 > 0)
        hit[ylo:yhi + 1, xlo:xhi + 1] = ~(neg & pos)
    return hit


def raster_image(spec: np.ndarray, bg_color: Sequence[int], h: int, w: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One image of ``spec`` rows (class, cy, cx, size, r, g, b; the first
    row of class 0 ends the list): (colors f32 [h, w, 3], occlusion-aware
    masks bool [n, h, w] of its n instances, in order, empty ones kept)."""
    spec = np.asarray(spec, np.int64).reshape(-1, 7)
    colors = np.empty((h, w, 3), _F32)
    colors[:] = np.asarray(bg_color, _F32)
    hits = []
    for row in spec:
        if row[0] <= 0:
            break
        hit = raster_instance(h, w, int(row[0]), int(row[1]), int(row[2]), int(row[3]))
        colors[hit] = row[4:7].astype(_F32)
        hits.append(hit)
    masks = np.stack(hits) if hits else np.zeros((0, h, w), bool)
    covered = np.zeros((h, w), bool)
    for j in range(len(hits) - 1, -1, -1):  # later instances erase earlier ones
        masks[j] &= ~covered
        covered |= hits[j]
    return colors, masks


def rasterize_shapes_batch(specs: np.ndarray, bg_colors: np.ndarray, height: int,
                           width: int, mean_pixel):
    """A whole batch, as the JAX package's native ``rasterize_shapes_batch``.

    specs int [B, I, 7]; bg_colors int [B, 3]. Returns (images f32 [B, H, W,
    3] minus ``mean_pixel``, masks f32 [B, I, H, W], boxes f32 [B, I, 4]
    normalized (y1, x1, y2, x2), class ids int32 [B, I]), each image's
    visible instances first and the rest zero."""
    specs = np.asarray(specs)
    b, max_inst = specs.shape[:2]
    h, w = height, width
    mean = np.asarray(mean_pixel, _F32)
    images = np.zeros((b, h, w, 3), _F32)
    masks = np.zeros((b, max_inst, h, w), _F32)
    boxes = np.zeros((b, max_inst, 4), _F32)
    classes = np.zeros((b, max_inst), np.int32)
    scale = np.array([h - 1, w - 1, h - 1, w - 1], _F32)
    for i in range(b):
        colors, hits = raster_image(specs[i], bg_colors[i], h, w)
        images[i] = colors - mean
        out = 0
        for j, hit in enumerate(hits):
            rows, cols = np.nonzero(hit.any(1))[0], np.nonzero(hit.any(0))[0]
            if not len(rows):
                continue  # fully occluded
            masks[i, out] = hit
            # pixel box (y1, x1, y2 + 1, x2 + 1) minus the [0, 0, 1, 1] shift
            px = np.array([rows[0], cols[0], rows[-1], cols[-1]], _F32)
            boxes[i, out] = px / scale
            classes[i, out] = specs[i, j, 0]
            out += 1
    return images, masks, boxes, classes
