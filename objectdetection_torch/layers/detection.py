"""Detection layer: classifier outputs → final detections.

Port of ``objectdetection_tpu.layers.detection.detection_layer``: per-ROI
argmax class, that class's delta × stddev, refine + clip to the window, keep
rows whose class is foreground and whose score clears the gate, class-aware
NMS, top ``detection_post_nms_instances`` → [B, N, (y1, x1, y2, x2, class,
score)], zero-padded.
"""

from __future__ import annotations

import torch

from objectdetection_torch.config import DetectorConfig
from objectdetection_torch.geometry import apply_box_deltas, clip_boxes
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
