"""Detection drawing in numpy.

Port of ``objectdetection_tpu.viz``: :func:`random_colors`,
:func:`draw_anchor_assignment` and :func:`draw_detections`. Box outlines
and the mask blend (threshold 0.5, alpha 0.45) follow the JAX package's
``cv2`` drawing; masks are resized with
:func:`~objectdetection_torch.data.preprocess.resize_bilinear`. A label is
drawn with a small built-in 3×5 bitmap font (upper case, digits, ``.``,
``-``, ``_``), or not at all with ``labels=False``; it does not match
``cv2.putText`` pixel for pixel.
"""

from __future__ import annotations

import colorsys
from typing import Optional, Sequence

import numpy as np

from objectdetection_torch.data.preprocess import resize_bilinear

# 3×5 glyphs, five rows of three bits each (top row first)
_GLYPHS = {
    "A": "010101111101101", "B": "110101110101110", "C": "011100100100011",
    "D": "110101101101110", "E": "111100110100111", "F": "111100110100100",
    "G": "011100101101011", "H": "101101111101101", "I": "111010010010111",
    "J": "001001001101010", "K": "101101110101101", "L": "100100100100111",
    "M": "101111111101101", "N": "110101101101101", "O": "010101101101010",
    "P": "110101110100100", "Q": "010101101110011", "R": "110101110101101",
    "S": "011100010001110", "T": "111010010010010", "U": "101101101101111",
    "V": "101101101101010", "W": "101101111111101", "X": "101101010101101",
    "Y": "101101010010010", "Z": "111001010100111",
    "0": "111101101101111", "1": "010110010010111", "2": "110001010100111",
    "3": "110001010001110", "4": "101101111001001", "5": "111100110001110",
    "6": "011100111101111", "7": "111001010010010", "8": "111101111101111",
    "9": "111101111001110", ".": "000000000000010", "-": "000000111000000",
    "_": "000000000000111", " ": "000000000000000",
}


def random_colors(n: int, seed: int = 0, bright: bool = True):
    """N visually distinct RGB colours from evenly spaced hues, shuffled."""
    rng = np.random.RandomState(seed)
    brightness = 1.0 if bright else 0.7
    hsv = [(i / max(n, 1), 1, brightness) for i in range(n)]
    colors = [colorsys.hsv_to_rgb(*c) for c in hsv]
    rng.shuffle(colors)
    return colors


def draw_rectangle(out: np.ndarray, box, color, thickness: int = 1) -> None:
    """Outline pixel box (y1, x1, y2, x2), corners inclusive, in place;
    clipped to the image. A thicker outline grows inwards and outwards."""
    h, w = out.shape[:2]
    y1, x1, y2, x2 = (int(v) for v in box)
    color = np.asarray(color, out.dtype)
    for t in range(-(thickness // 2), thickness - thickness // 2):
        ya, xa, yb, xb = y1 - t, x1 - t, y2 + t, x2 + t
        x_lo, x_hi = max(min(xa, xb), 0), min(max(xa, xb), w - 1)
        y_lo, y_hi = max(min(ya, yb), 0), min(max(ya, yb), h - 1)
        for y in (ya, yb):
            if 0 <= y < h and x_lo <= x_hi:
                out[y, x_lo:x_hi + 1] = color
        for x in (xa, xb):
            if 0 <= x < w and y_lo <= y_hi:
                out[y_lo:y_hi + 1, x] = color


def draw_text(out: np.ndarray, text: str, y: int, x: int, color) -> None:
    """Text with the 3×5 font, its top-left corner at (y, x), in place."""
    h, w = out.shape[:2]
    color = np.asarray(color, out.dtype)
    for i, ch in enumerate(text.upper()):
        glyph = _GLYPHS.get(ch, _GLYPHS["-"])
        bits = np.array([int(b) for b in glyph], bool).reshape(5, 3)
        ys, xs = np.nonzero(bits)
        ys, xs = ys + y, xs + x + 4 * i
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        out[ys[keep], xs[keep]] = color


def draw_anchor_assignment(image: np.ndarray, anchors: np.ndarray, target_class: np.ndarray,
                           gt_boxes: Optional[np.ndarray] = None,
                           max_negative: int = 50) -> np.ndarray:
    """RPN target assignment: GT boxes (white), positive anchors (green), a
    sample of negatives (red). anchors [A, 4] pixels; target_class [A] in
    {-1, 0, 1}."""
    out = image.astype(np.uint8).copy()

    def draw(boxes, color, thickness=1):
        for y1, x1, y2, x2 in np.asarray(boxes, np.int32):
            draw_rectangle(out, (y1, x1, y2, x2), color, thickness)

    neg = anchors[target_class == -1]
    if len(neg) > max_negative:
        neg = neg[:: max(len(neg) // max_negative, 1)][:max_negative]
    draw(neg, (220, 60, 60))
    draw(anchors[target_class == 1], (40, 220, 40))
    if gt_boxes is not None:
        draw(gt_boxes, (255, 255, 255), 2)
    return out


def draw_detections(image: np.ndarray, boxes: np.ndarray, class_ids: np.ndarray,
                    scores: np.ndarray, class_names: Optional[Sequence[str]] = None,
                    masks: Optional[np.ndarray] = None, mask_threshold: float = 0.5,
                    labels: bool = True) -> np.ndarray:
    """Boxes, labels and optional masks drawn onto a copy of ``image`` (uint8).

    boxes [N, 4] pixels (y1, x1, y2, x2); masks [N, mh, mw] per-ROI soft
    masks, resized into each box and blended where above ``mask_threshold``.
    """
    out = image.astype(np.uint8).copy()
    colors = random_colors(max(len(boxes), 1))
    h, w = out.shape[:2]
    for i, (y1, x1, y2, x2) in enumerate(np.asarray(boxes, np.int32)):
        color = tuple(int(255 * c) for c in colors[i % len(colors)])
        y1, x1 = max(y1, 0), max(x1, 0)
        y2, x2 = min(y2, h - 1), min(x2, w - 1)
        if y2 <= y1 or x2 <= x1:
            continue
        draw_rectangle(out, (y1, x1, y2, x2), color)
        if labels:
            label = class_names[int(class_ids[i])] if class_names else str(int(class_ids[i]))
            draw_text(out, f"{label} {scores[i]:.2f}", max(y1 - 7, 0), x1, color)
        if masks is not None:
            mask = resize_bilinear(masks[i].astype(np.float32), (y2 - y1, x2 - x1))
            region = out[y1:y2, x1:x2].astype(np.float32)
            alpha = (mask > mask_threshold)[:, :, None] * 0.45
            region = region * (1 - alpha) + np.array(color, np.float32) * alpha
            out[y1:y2, x1:x2] = region.astype(np.uint8)
    return out
