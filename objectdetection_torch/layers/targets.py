"""Training-target assignment, batched over images, with static shapes.

Port of ``objectdetection_tpu.layers.targets`` (``_rank_among``,
``rpn_targets``, ``detection_targets``). JAX maps those over the batch with
``vmap``; here every tensor carries the batch dimension.

Random subsampling draws one uniform number per candidate and ranks the
candidates by it. JAX draws that noise with ``jax.random.uniform``, which
torch cannot reproduce, so each function takes its noise as a pair of
tensors (positives, negatives), each [B, N] in [0, 1), and draws it from a
``torch.Generator`` when none is given. Sorts are stable, as ``jnp.argsort``
is, so equal noise values rank by index on both sides.

Matching rules (in this order): negatives are ``max IoU < 0.3``, then the
best anchor of every valid GT is forced positive, then ``max IoU >= 0.7`` is
positive; positives are capped at half the budget and negatives fill the
rest.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from objectdetection_torch.geometry import encode_box_deltas, iou_matrix
from objectdetection_torch.ops import anchor_match as anchor_match_op
from objectdetection_torch.ops.roi_align import crop_and_resize

Noise = Tuple[torch.Tensor, torch.Tensor]  # (positives, negatives), each [B, N]


def uniform_noise(shape, generator: Optional[torch.Generator], device) -> Noise:
    """Two [*shape] uniform [0, 1) tensors from ``generator`` (drawn on its
    device; torch's default CPU generator if None), moved to ``device``."""
    gen_device = generator.device if generator is not None else "cpu"
    return tuple(torch.rand(shape, generator=generator, device=gen_device).to(device)
                 for _ in range(2))


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _rank_among(mask: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Rank of each True entry among the True entries of its row, in the
    order of ``noise`` (0..k-1); False entries get N. mask, noise [B, N]."""
    n = mask.shape[-1]
    sort_key = torch.where(mask, noise, _f32(2.0, noise))
    order = torch.argsort(sort_key, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=mask.device).expand_as(order))
    return torch.where(mask, ranks, n).to(torch.int32)


class RPNTargets(NamedTuple):
    target_class: torch.Tensor  # [B, A] int32 in {-1, 0, +1}
    target_deltas: torch.Tensor  # [B, rpn_train_anchors, 4] packed positives, zero-pad
    num_positives: torch.Tensor  # [B] int32


def rpn_targets(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    config,
    noise: Optional[Noise] = None,
    generator: Optional[torch.Generator] = None,
    encode_fn=None,
) -> RPNTargets:
    """RPN classification/regression targets.

    anchors [A, 4] (the frame of gt_boxes); gt_boxes [B, G, 4] zero-padded;
    gt_valid [B, G] bool; noise: (positives, negatives), each [B, A].
    ``encode_fn`` (boxes, gt) → deltas overrides the center-form encoding.
    Deltas of kept positives are packed in ascending anchor order.
    """
    a = anchors.shape[0]
    b = gt_boxes.shape[0]
    budget = config.rpn_train_anchors_per_image
    half = budget // 2
    encode_fn = encode_fn or encode_box_deltas
    if noise is None:
        noise = uniform_noise((b, a), generator, anchors.device)
    gt_valid = gt_valid.to(torch.bool)

    match = anchor_match_op.anchor_match(anchors, gt_boxes, gt_valid)
    target = torch.zeros((b, a), dtype=torch.int32, device=anchors.device)
    target = torch.where(match.anchor_max < 0.3, -1, target)
    # the best anchor of each valid GT is positive even below 0.7; an index
    # named by several GTs is forced if any of them is valid (scatter-max)
    force_pos = torch.zeros((b, a), dtype=torch.int32, device=anchors.device).scatter_reduce(
        1, match.gt_argmax.to(torch.int64), gt_valid.to(torch.int32), reduce="amax") > 0
    target = torch.where(force_pos, 1, target)
    target = torch.where(match.anchor_max >= 0.7, 1, target)
    # images with no valid GT get no positives
    any_gt = gt_valid.any(dim=1, keepdim=True)
    target = torch.where(any_gt, target, torch.clamp(target, max=0))

    is_pos = target == 1
    pos_rank = _rank_among(is_pos, noise[0])
    keep_pos = is_pos & (pos_rank < half)
    n_pos = keep_pos.sum(dim=1, keepdim=True)
    is_neg = target == -1
    neg_rank = _rank_among(is_neg, noise[1])
    keep_neg = is_neg & (neg_rank < budget - n_pos)
    target = torch.where(is_pos & ~keep_pos, 0, target)
    target = torch.where(is_neg & ~keep_neg, 0, target)

    matched_gt = torch.gather(
        gt_boxes, 1, match.anchor_argmax.to(torch.int64)[..., None].expand(b, a, 4))
    stddev = _f32(config.rpn_bbox_stddev, anchors)
    deltas_all = encode_fn(anchors[None].expand(b, a, 4), matched_gt) / stddev
    keep_final = target == 1
    order = torch.argsort(torch.where(keep_final, 0, 1), dim=1, stable=True)[:, :budget]
    packed = torch.gather(deltas_all, 1, order[..., None].expand(*order.shape, 4))
    slot_valid = torch.gather(keep_final, 1, order)
    packed = torch.where(slot_valid[..., None], packed, torch.zeros_like(packed))
    return RPNTargets(
        target_class=target,
        target_deltas=packed,
        num_positives=keep_final.sum(dim=1).to(torch.int32),
    )


class DetectionTargets(NamedTuple):
    rois: torch.Tensor  # [B, T, 4] sampled proposals (positives first), zero-pad
    target_class_ids: torch.Tensor  # [B, T] int32, 0 for negatives and padding
    target_deltas: torch.Tensor  # [B, T, 4] zero except positive rows
    target_masks: torch.Tensor  # [B, T, mh, mw] {0, 1}; zeros without masks
    pos_mask: torch.Tensor  # [B, T] bool: sampled positives
    valid_mask: torch.Tensor  # [B, T] bool: sampled rows (positive or negative)


def detection_targets(
    proposals: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_class_ids: torch.Tensor,
    config,
    noise: Optional[Noise] = None,
    generator: Optional[torch.Generator] = None,
    gt_masks: Optional[torch.Tensor] = None,
    encode_fn=None,
    masks_are_mini: bool = False,
) -> DetectionTargets:
    """Second-stage training targets.

    proposals [B, P, 4] normalized, zero-padded; gt_boxes [B, G, 4];
    gt_class_ids [B, G] int (0 = padding); noise: (positives, negatives),
    each [B, P]. gt_masks [B, G, H, W]: full-frame masks, or with
    ``masks_are_mini`` mini-masks in their GT box's frame.
    """
    b, p = proposals.shape[:2]
    g = gt_boxes.shape[1]
    t = config.train_rois_per_image
    num_pos_budget = int(t * config.roi_positive_ratio)
    dev = proposals.device
    if noise is None:
        noise = uniform_noise((b, p), generator, dev)

    prop_valid = proposals.abs().sum(dim=-1) > 0
    gt_valid = gt_class_ids > 0
    iou = iou_matrix(proposals, gt_boxes)  # [B, P, G]
    iou = torch.where(gt_valid[:, None, :], iou, torch.zeros_like(iou))
    roi_iou_max = iou.max(dim=-1).values
    is_pos = prop_valid & (roi_iou_max >= 0.5)
    is_neg = prop_valid & (roi_iou_max < 0.5)

    pos_rank = _rank_among(is_pos, noise[0])
    keep_pos = is_pos & (pos_rank < num_pos_budget)
    n_pos = keep_pos.sum(dim=-1, keepdim=True).to(torch.int32)
    # negatives scale with the positive count
    neg_budget = (_f32(1.0 / config.roi_positive_ratio, proposals) * n_pos.to(torch.float32)
                  ).to(torch.int32) - n_pos
    neg_rank = _rank_among(is_neg, noise[1])
    keep_neg = is_neg & (neg_rank < neg_budget)

    # pack: positives first (by random rank), then negatives, then padding
    sort_key = torch.where(keep_pos, pos_rank, torch.where(keep_neg, p + neg_rank, 3 * p))
    order = torch.argsort(sort_key, dim=-1, stable=True)[:, :t]
    pad_row = torch.arange(t, device=dev) >= p
    if p < t:  # fewer proposals than the ROI budget
        order = torch.cat([order, order.new_zeros((b, t - p))], dim=1)
    rois = torch.gather(proposals, 1, order[..., None].expand(b, t, 4))
    row_pos = torch.gather(keep_pos, 1, order) & ~pad_row
    row_valid = torch.gather(keep_pos | keep_neg, 1, order) & ~pad_row
    rois = torch.where(row_valid[..., None], rois, torch.zeros_like(rois))

    gt_assign = torch.argmax(torch.gather(iou, 1, order[..., None].expand(b, t, g)), dim=-1)
    tgt_class = torch.gather(gt_class_ids, 1, gt_assign).to(torch.int32)
    tgt_class = torch.where(row_pos, tgt_class, 0)
    matched_gt = torch.gather(gt_boxes, 1, gt_assign[..., None].expand(b, t, 4))
    deltas = (encode_fn or encode_box_deltas)(rois, matched_gt) / _f32(config.bbox_stddev, rois)
    deltas = torch.where(row_pos[..., None], deltas, torch.zeros_like(deltas))
    deltas = torch.nan_to_num(deltas)  # log(0/0) of padded rows

    mh, mw = config.mask_shape
    if gt_masks is not None:
        # crop each ROI's matched GT mask to the ROI, at the mask-head size
        hm, wm = gt_masks.shape[2:]
        matched = torch.gather(gt_masks.to(torch.float32), 1,
                               gt_assign[..., None, None].expand(b, t, hm, wm))
        if masks_are_mini:
            # mini-masks live in their GT box's frame: the ROI in box-relative
            # coordinates
            eps = _f32(1e-6, rois)
            gh = torch.maximum(matched_gt[..., 2] - matched_gt[..., 0], eps)
            gw = torch.maximum(matched_gt[..., 3] - matched_gt[..., 1], eps)
            crop_boxes = torch.stack([
                (rois[..., 0] - matched_gt[..., 0]) / gh,
                (rois[..., 1] - matched_gt[..., 1]) / gw,
                (rois[..., 2] - matched_gt[..., 0]) / gh,
                (rois[..., 3] - matched_gt[..., 1]) / gw,
            ], dim=-1)
        else:
            crop_boxes = rois
        crops = crop_and_resize(matched[..., None], crop_boxes[..., None, :], (mh, mw))
        target_masks = crops[:, :, 0, :, :, 0]
        target_masks = torch.where(row_pos[..., None, None], torch.round(target_masks),
                                   torch.zeros_like(target_masks))
    else:
        target_masks = torch.zeros((b, t, mh, mw), dtype=torch.float32, device=dev)

    return DetectionTargets(
        rois=rois,
        target_class_ids=tgt_class,
        target_deltas=deltas,
        target_masks=target_masks,
        pos_mask=row_pos,
        valid_mask=row_valid,
    )
