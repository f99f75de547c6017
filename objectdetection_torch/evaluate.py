"""Detection-quality evaluation (COCO-style mAP), pure numpy.

A copy of ``objectdetection_tpu.evaluate`` (the port does not import the JAX
package): per-class score-ranked greedy matching at one or many IoU
thresholds, by box IoU or, with ``use_masks``, mask IoU; COCO crowd regions
as ignore regions; all-points precision/recall integration.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    y1 = np.maximum(a[:, None, 0], b[None, :, 0])
    x1 = np.maximum(a[:, None, 1], b[None, :, 1])
    y2 = np.minimum(a[:, None, 2], b[None, :, 2])
    x2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-points interpolated AP (COCO style)."""
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def _mask_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of boolean instance masks: [N, H, W] × [M, H, W] → [N, M]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    af = a.reshape(len(a), -1).astype(np.float32)
    bf = b.reshape(len(b), -1).astype(np.float32)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


class DetectionEvaluator:
    """Accumulates per-image predictions/GT; computes per-class AP and mAP.

    Matching uses box IoU by default; pass instance masks to `add_image` and
    set `use_masks=True` to score mask mAP (segm metric) instead.
    """

    def __init__(
        self,
        num_classes: int,
        iou_thresholds: Sequence[float] = (0.5,),
        use_masks: bool = False,
    ):
        self.num_classes = num_classes
        self.iou_thresholds = list(iou_thresholds)
        self.use_masks = use_masks
        self._images: List[dict] = []

    def add_image(
        self,
        pred_boxes: np.ndarray,
        pred_classes: np.ndarray,
        pred_scores: np.ndarray,
        gt_boxes: np.ndarray,
        gt_classes: np.ndarray,
        pred_masks: np.ndarray = None,
        gt_masks: np.ndarray = None,
        ignore_boxes: np.ndarray = None,
        ignore_classes: np.ndarray = None,
    ) -> None:
        """Boxes are [N, 4] (y1, x1, y2, x2) in any consistent frame; masks
        (when scoring mask mAP) are [N, H, W] booleans in the image frame.

        `ignore_boxes`/`ignore_classes`: regions (e.g. COCO crowds) — an
        unmatched detection whose intersection-over-detection-area with a
        same-class ignore region exceeds the IoU threshold is dropped from
        scoring entirely (pycocotools crowd semantics)."""
        row = dict(
            pb=np.asarray(pred_boxes, np.float32).reshape(-1, 4),
            pc=np.asarray(pred_classes, np.int32).reshape(-1),
            ps=np.asarray(pred_scores, np.float32).reshape(-1),
            gb=np.asarray(gt_boxes, np.float32).reshape(-1, 4),
            gc=np.asarray(gt_classes, np.int32).reshape(-1),
            ib=np.asarray(
                ignore_boxes if ignore_boxes is not None else np.zeros((0, 4)),
                np.float32,
            ).reshape(-1, 4),
            ic=np.asarray(
                ignore_classes if ignore_classes is not None else np.zeros((0,)),
                np.int32,
            ).reshape(-1),
        )
        if self.use_masks:
            assert pred_masks is not None and gt_masks is not None
            row["pm"] = np.asarray(pred_masks, bool)
            row["gm"] = np.asarray(gt_masks, bool)
        self._images.append(row)

    def _class_pr(self, cls: int, iou_thresh: float):
        scores, matches = [], []
        total_gt = 0
        for img in self._images:
            gt_mask = img["gc"] == cls
            gt = img["gb"][gt_mask]
            total_gt += len(gt)
            pm = img["pc"] == cls
            pb, ps = img["pb"][pm], img["ps"][pm]
            order = np.argsort(-ps)
            pb, ps = pb[order], ps[order]
            if self.use_masks:
                iou = _mask_iou_matrix(
                    img["pm"][pm][order], img["gm"][gt_mask]
                )
            else:
                iou = _iou_matrix(pb, gt)
            # same-class ignore (crowd) regions: intersection / det area
            ig = img["ib"][img["ic"] == cls]
            if len(ig) and len(pb):
                y1 = np.maximum(pb[:, None, 0], ig[None, :, 0])
                x1 = np.maximum(pb[:, None, 1], ig[None, :, 1])
                y2 = np.minimum(pb[:, None, 2], ig[None, :, 2])
                x2 = np.minimum(pb[:, None, 3], ig[None, :, 3])
                inter = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
                det_area = np.maximum(
                    (pb[:, 2] - pb[:, 0]) * (pb[:, 3] - pb[:, 1]), 1e-9
                )
                crowd_iou = (inter / det_area[:, None]).max(axis=1)
            else:
                crowd_iou = np.zeros(len(pb))

            taken = np.zeros(len(gt), bool)
            for i in range(len(pb)):
                if len(gt) == 0:
                    if crowd_iou[i] < iou_thresh:
                        scores.append(ps[i])
                        matches.append(0)
                    continue
                j = int(np.argmax(np.where(taken, -1.0, iou[i])))
                if iou[i, j] >= iou_thresh and not taken[j]:
                    taken[j] = True
                    scores.append(ps[i])
                    matches.append(1)
                elif crowd_iou[i] < iou_thresh:
                    scores.append(ps[i])
                    matches.append(0)
                # else: unmatched but inside a crowd region → ignored
        return np.asarray(scores), np.asarray(matches), total_gt

    def evaluate(self) -> Dict[str, float]:
        """Returns {'mAP': ..., 'AP50': ..., 'per_class': {...}} averaged over
        IoU thresholds and classes with ground truth."""
        per_class: Dict[int, float] = {}
        ap_per_thresh = {t: [] for t in self.iou_thresholds}
        for cls in range(1, self.num_classes):
            aps = []
            for t in self.iou_thresholds:
                scores, matches, total_gt = self._class_pr(cls, t)
                if total_gt == 0:
                    continue
                order = np.argsort(-scores)
                m = matches[order]
                tp = np.cumsum(m)
                fp = np.cumsum(1 - m)
                recall = tp / total_gt
                precision = tp / np.maximum(tp + fp, 1)
                ap = average_precision(recall, precision)
                aps.append(ap)
                ap_per_thresh[t].append(ap)
            if aps:
                per_class[cls] = float(np.mean(aps))
        m_ap = float(np.mean(list(per_class.values()))) if per_class else 0.0
        out = {"mAP": m_ap, "per_class": per_class}
        if 0.5 in ap_per_thresh and ap_per_thresh[0.5]:
            out["AP50"] = float(np.mean(ap_per_thresh[0.5]))
        return out


def coco_iou_thresholds() -> List[float]:
    """The COCO 0.50:0.05:0.95 sweep."""
    return [0.5 + 0.05 * i for i in range(10)]
