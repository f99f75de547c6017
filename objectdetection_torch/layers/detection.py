"""Detection layers: classifier outputs → final detections [B, N, (y1, x1,
y2, x2, class, score)], zero-padded.

:func:`detection_layer` ports ``objectdetection_tpu.layers.detection.
detection_layer`` (matterport's rule): per-ROI argmax class, that class's
delta × stddev, refine + clip to the window, keep rows whose class is
foreground and whose score clears the gate, class-aware NMS, top
``detection_post_nms_instances``.

:func:`per_class_detection_layer` has no JAX counterpart: every (ROI, class)
pair of class-agnostic boxes, as mmdetection's ``multiclass_nms`` takes them
(Hybrid Task Cascade's detections).
"""

from __future__ import annotations

import torch

from objectdetection_torch import metrics
from objectdetection_torch.config import DetectorConfig
from objectdetection_torch.geometry import apply_box_deltas, clip_boxes
from objectdetection_torch.layers.proposals import top_k_stable
from objectdetection_torch.ops.nms import non_max_suppression


def detection_layer(
    proposals: torch.Tensor,
    class_probs: torch.Tensor,
    bbox_deltas: torch.Tensor,
    window: torch.Tensor,
    config: DetectorConfig,
) -> torch.Tensor:
    """proposals [B, P, 4], class_probs [B, P, K], bbox_deltas [B, P, K, 4],
    window [B, 4] normalized → [B, N, 6]."""
    n_out = config.detection_post_nms_instances
    dev = proposals.device
    stddev = torch.tensor(config.bbox_stddev, dtype=torch.float32, device=dev)
    class_ids = torch.argmax(class_probs, dim=-1)  # first max on ties
    scores = torch.gather(class_probs, 2, class_ids[..., None])[..., 0]
    d = torch.gather(
        bbox_deltas, 2, class_ids[..., None, None].expand(*class_ids.shape, 1, 4)
    )[:, :, 0, :]
    refined = apply_box_deltas(proposals, d * stddev)
    refined = clip_boxes(refined, window[:, None, :])

    gate = torch.tensor(config.detection_min_threshold, dtype=scores.dtype, device=dev)
    valid = (class_ids > 0) & (scores > gate)
    res = non_max_suppression(
        refined, scores, n_out, config.detection_nms_threshold,
        valid=valid, class_ids=class_ids.to(torch.int32),
    )
    idx = res.indices.clamp(min=0)
    out = torch.cat(
        [
            torch.gather(refined, 1, idx[..., None].expand(*idx.shape, 4)),
            torch.gather(class_ids, 1, idx)[..., None].to(torch.float32),
            torch.gather(scores, 1, idx)[..., None],
        ],
        dim=-1,
    )
    return torch.where(res.valid[..., None], out, torch.zeros_like(out))


def per_class_detection_layer(boxes: torch.Tensor, class_probs: torch.Tensor,
                              rows_valid: torch.Tensor, score_threshold: float,
                              config: DetectorConfig) -> torch.Tensor:
    """boxes [B, R, 4] (one box a ROI, shared by its classes), class_probs
    [B, R, K] (class 0 the background), rows_valid [B, R] → [B, N, 6].

    Every (ROI, foreground class) pair of a valid ROI scoring above
    ``score_threshold`` is a candidate. Each (image, class) is one NMS
    problem over the R shared boxes: B × (K − 1) problems in one B2 pass at
    ``detection_nms_threshold``, each stopped at N survivors (N =
    ``detection_post_nms_instances``), then the best N of the B × (K − 1)
    × N survivors of each image. No class can bring more than N rows into
    an image's best N, so this is NMS over every candidate of each class
    followed by the best N (mmdetection's ``batched_nms`` and
    ``max_per_img``). Equal scores go to the lower class, then to the lower
    ROI. Under ``metrics.collect`` it counts ``htc_detection.candidates``
    (the pairs into NMS) and ``htc_detection.slots`` (B × R × (K − 1))."""
    b, r, k = class_probs.shape
    nc, n_out = k - 1, config.detection_post_nms_instances
    scores = class_probs[..., 1:].transpose(1, 2).reshape(b * nc, r)
    valid = (scores > score_threshold) & rows_valid.repeat_interleave(nc, dim=0)
    if metrics.collecting():
        metrics.count("htc_detection.candidates", valid.sum())
        metrics.count("htc_detection.slots", valid.numel())
    problems = boxes.repeat_interleave(nc, dim=0)  # [B·(K − 1), R, 4]
    res = non_max_suppression(problems, scores, n_out, config.detection_nms_threshold,
                              valid=valid)
    kept = torch.gather(scores, 1, res.indices.clamp(min=0))
    kept = torch.where(res.valid, kept, torch.full_like(kept, -1.0))
    top, pick = top_k_stable(kept.reshape(b, nc * n_out), n_out)
    rows = torch.gather(res.indices.reshape(b, nc * n_out), 1, pick).clamp(min=0)
    out = torch.cat([torch.gather(boxes, 1, rows[..., None].expand(b, n_out, 4)),
                     (pick // n_out + 1)[..., None].to(torch.float32), top[..., None]], dim=-1)
    return torch.where((top >= 0)[..., None], out, torch.zeros_like(out))
