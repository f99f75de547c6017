"""Judging detections against the reference's.

Detections are rows (y1, x1, y2, x2, class, score), zero rows padding.
In each image the reference's detections, best score first, are matched
one to one to the program's detection of the same class that overlaps
them most, at IoU 0.5 or more. Then:

- ``score_gap``: for a matched pair the difference of their scores; for a
  detection on one side only, how far its score lies above the gate (a
  detection that barely clears the gate may rightly fall on either side of
  it; one far above it may not): the largest over the sample, and the
  mean.
- ``box_gap``: the mean of 1 − IoU over the matched pairs.
- ``mask_gap``: the mean absolute difference between each of the
  program's 28×28 soft masks and the one the reference computes at the
  program's own box and class (``want_masks``), over the program's
  detections: the mask layer judged on its own answers, whatever the
  matching did.
- ``missed``: the share of the reference's confident detections (scoring
  ``margin`` or more above the gate) that found no partner; ``extra`` the
  same share of the program's. A detection near the gate may rightly lack
  a partner; a confident one may not.
- ``lost``: the share of the sample's images with two or more confident
  reference detections in which the program misses more than half of
  them: an answer lost whole, as an image left out would be (an image with
  one confident detection says too little to call it lost).
- ``matched``: the share of detections, both sides counted, that found a
  partner.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ih = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iw = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ih * iw
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = aa[:, None] + ab[None, :] - inter
    same = (a[:, None, :] == b[None, :, :]).all(-1)  # equal boxes of no area
    return np.where(union > 0, inter / np.where(union > 0, union, 1), same.astype(float))


def compare(got: np.ndarray, want: np.ndarray, gate: float,
            got_masks: Optional[np.ndarray] = None,
            want_masks: Optional[np.ndarray] = None, margin: float = 0.1) -> Dict[str, float]:
    """got, want [B, N, 6]; ``got_masks`` [B, N, h, w] and ``want_masks``
    (the reference's at the rows of ``got``), or None. Returns the numbers
    of the module doc over the whole sample."""
    score_gaps, box_gaps, mask_gaps = [], [], []
    n_got = n_want = n_pairs = 0
    sure_want = sure_missed = sure_got = sure_extra = 0
    lost = images = 0
    for i in range(got.shape[0]):
        g = got[i][got[i, :, 5] > 0]
        gi = np.nonzero(got[i, :, 5] > 0)[0]
        w = want[i][want[i, :, 5] > 0]
        n_got += len(g)
        n_want += len(w)
        ious = _iou(w[:, :4], g[:, :4]) if len(g) and len(w) else np.zeros((len(w), len(g)))
        free = np.ones(len(g), bool)
        img_want = img_missed = 0
        for r in np.argsort(-w[:, 5], kind="stable"):
            ok = free & (g[:, 4] == w[r, 4]) & (ious[r] >= 0.5)
            sure = w[r, 5] >= gate + margin
            img_want += sure
            if not ok.any():
                score_gaps.append(w[r, 5] - gate)
                img_missed += sure
                continue
            p = int(np.argmax(np.where(ok, ious[r], -1.0)))
            free[p] = False
            n_pairs += 1
            score_gaps.append(abs(w[r, 5] - g[p, 5]))
            box_gaps.append(1.0 - ious[r, p])
        score_gaps += list(g[free, 5] - gate)
        if got_masks is not None:
            mask_gaps += [float(np.abs(got_masks[i, j].astype(np.float64)
                                       - want_masks[i, j]).mean()) for j in gi]
        sure_want += img_want
        sure_missed += img_missed
        if img_want >= 2:
            images += 1
            lost += 2 * img_missed > img_want
        sure_got += int((g[:, 5] >= gate + margin).sum())
        sure_extra += int((g[free, 5] >= gate + margin).sum())
    out = {
        "score_gap": float(max(score_gaps, default=0.0)),
        "score_gap_mean": float(np.mean(score_gaps)) if score_gaps else 0.0,
        "box_gap": float(np.mean(box_gaps)) if box_gaps else 0.0,
        "missed": float(sure_missed / max(sure_want, 1)),
        "extra": float(sure_extra / max(sure_got, 1)),
        "lost": float(lost / max(images, 1)),
        "matched": 2.0 * n_pairs / max(n_got + n_want, 1),
        "detections_per_image": n_want / max(got.shape[0], 1),
        "program_detections_per_image": n_got / max(got.shape[0], 1),
    }
    if got_masks is not None:
        out["mask_gap"] = float(np.mean(mask_gaps)) if mask_gaps else 0.0
    return out
