"""Proposal layer: RPN outputs + anchors → top proposals.

Port of ``objectdetection_tpu.layers.proposals.proposal_layer``: top-k
pre-NMS anchors by foreground score → decode with the stddev-scaled deltas →
clip to [0, 1] → per-image NMS → zero-pad to the post-NMS budget (the
training or the inference budget).

Top-k is a stable descending sort: ties go to the lower index, as with
``lax.top_k``. ``use_approx_topk`` is treated as exact, which training
requires anyway.
"""

from __future__ import annotations

import torch

from objectdetection_torch.config import DetectorConfig
from objectdetection_torch.geometry import apply_box_deltas, clip_boxes
from objectdetection_torch.ops.nms import nms_boxes


def top_k_stable(scores: torch.Tensor, k: int):
    """Top k along the last axis, ties to the lower index: (values, indices)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_stable_nonneg(scores: torch.Tensor, k: int):
    """:func:`top_k_stable` for f32 scores ≥ 0 (probabilities; no NaN, no
    −0.0) without sorting the whole axis: one ``torch.topk`` over int64 keys
    that hold a score's bits above its reversed index, so no two keys tie
    and the order is the stable sort's. For k much smaller than the axis
    (RetinaNet's 1000 of 11.8 M pairs a level)."""
    n = scores.shape[-1]
    keys = scores.contiguous().view(torch.int32).to(torch.int64)
    keys <<= 32
    keys |= torch.arange(n - 1, -1, -1, device=scores.device)
    top = torch.topk(keys, k, dim=-1).values
    idx = (n - 1) - (top & 0xFFFFFFFF)
    return torch.gather(scores, -1, idx), idx


def proposal_layer(
    rpn_probs: torch.Tensor,
    rpn_deltas: torch.Tensor,
    anchors: torch.Tensor,
    config: DetectorConfig,
    training: bool = False,
) -> torch.Tensor:
    """rpn_probs [B, A, 2], rpn_deltas [B, A, 4], anchors [A, 4] →
    [B, P, 4] normalized proposals, zero-padded (P = the post-NMS budget of
    training or inference)."""
    post_nms = config.post_nms_rois_training if training else config.post_nms_rois_inference
    b, a = rpn_probs.shape[:2]
    pre_nms = min(config.pre_nms_rois_count, a)
    stddev = torch.tensor(config.rpn_bbox_stddev, dtype=torch.float32,
                          device=rpn_deltas.device)
    top_scores, ix = top_k_stable(rpn_probs[..., 1], pre_nms)
    boxes_all = apply_box_deltas(anchors[None].expand(b, a, 4), rpn_deltas * stddev)
    boxes_all = clip_boxes(boxes_all, (0.0, 0.0, 1.0, 1.0))
    boxes = torch.gather(boxes_all, 1, ix[..., None].expand(b, pre_nms, 4))
    return nms_boxes(boxes, top_scores, post_nms, config.rpn_nms_threshold,
                     assume_sorted=True)
