"""Detection losses.

Port of ``objectdetection_tpu.losses``: the two RPN losses, the three
second-stage losses and their sum, as masked means over static shapes.
``mrcnn_box_loss(compat_reference=True)`` reproduces the TF reference's
binary cross-entropy on box deltas; the default is smooth-L1.

Each loss divides by a count over its batch (non-neutral or positive
anchors, positive ROIs, ROIs whose predicted class is active). ``count``
maps that count to the one to divide by: :func:`this_batch` by default; a
data-parallel step (``parallel.py``) passes the sum over its ``data`` group,
so that each process's loss is its own numerator over the global batch's
count and the processes' losses sum to the whole batch's, as in JAX's
global masked means.

Gradients follow JAX's: ``jnp.clip`` is ``minimum(maximum(x, lo), hi)``,
whose gradient splits half and half where x sits exactly on a bound, and so
is :func:`_clip` (``torch.clamp`` would pass all of it).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber, delta 1)."""
    absx = x.abs()
    return torch.where(absx < 1.0, 0.5 * absx * absx, absx - 0.5)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


Count = Callable[[torch.Tensor], torch.Tensor]


def this_batch(count: torch.Tensor) -> torch.Tensor:
    """The default ``count``: a loss's count over its own batch."""
    return count


def _masked_mean(values: torch.Tensor, mask: torch.Tensor, count: Count) -> torch.Tensor:
    mask = torch.broadcast_to(mask, values.shape)
    denom = count(mask.sum())
    mean = (values * mask).sum() / torch.clamp(denom, min=1)
    return torch.where(denom > 0, mean, torch.zeros_like(mean))


def rpn_class_loss(target_class: torch.Tensor, logits: torch.Tensor,
                   count: Count = this_batch) -> torch.Tensor:
    """fg/bg cross-entropy over non-neutral anchors: target_class [B, A] in
    {-1, 0, 1}, logits [B, A, 2]."""
    non_neutral = target_class != 0
    labels = (target_class == 1).to(torch.int64)
    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return _masked_mean(ce, non_neutral.to(ce.dtype), count)


def rpn_box_loss(target_deltas: torch.Tensor, pred_deltas: torch.Tensor,
                 target_class: torch.Tensor, count: Count = this_batch) -> torch.Tensor:
    """Smooth-L1 on positive anchors: predictions gathered at the positive
    anchors in ascending order against the packed targets [B, K, 4];
    pred_deltas [B, A, 4]; target_class [B, A]."""
    k = target_deltas.shape[1]
    is_pos = target_class == 1
    order = torch.argsort(torch.where(is_pos, 0, 1), dim=1, stable=True)[:, :k]
    pred_pos = torch.gather(pred_deltas, 1, order[..., None].expand(*order.shape, 4))
    slot_valid = torch.gather(is_pos, 1, order)
    err = smooth_l1(target_deltas - pred_pos)
    total = count(slot_valid.sum() * 4)
    loss = (err * slot_valid[..., None]).sum() / torch.clamp(total, min=1)
    return torch.where(total > 0, loss, torch.zeros_like(loss))


def mrcnn_class_loss(target_class_ids: torch.Tensor, pred_logits: torch.Tensor,
                     active_class_ids: torch.Tensor, count: Count = this_batch) -> torch.Tensor:
    """Softmax cross-entropy over sampled ROIs, each row weighted by whether
    its predicted class is active in the image's dataset."""
    logp = F.log_softmax(pred_logits, dim=-1)
    ce = -torch.gather(logp, -1, target_class_ids.to(torch.int64)[..., None])[..., 0]
    pred_class = torch.argmax(pred_logits, dim=-1)
    pred_active = torch.gather(active_class_ids, -1, pred_class).to(ce.dtype)
    denom = count(pred_active.sum())
    loss = (ce * pred_active).sum() / torch.clamp(denom, min=1)
    return torch.where(denom > 0, loss, torch.zeros_like(loss))


def mrcnn_box_loss(target_deltas: torch.Tensor, pred_deltas: torch.Tensor,
                   target_class_ids: torch.Tensor, compat_reference: bool = False,
                   count: Count = this_batch) -> torch.Tensor:
    """Box loss on positive ROIs for each ROI's target class: pred_deltas
    [B, T, C, 4]; smooth-L1, or the reference's binary CE."""
    pos = target_class_ids > 0
    cls = torch.clamp(target_class_ids, min=0).to(torch.int64)
    pred = torch.gather(pred_deltas, 2, cls[..., None, None].expand(*cls.shape, 1, 4))[:, :, 0]
    if compat_reference:
        p = _clip(pred, 1e-7, 1 - 1e-7)
        err = -(target_deltas * torch.log(p) + (1 - target_deltas) * torch.log(1 - p))
    else:
        err = smooth_l1(target_deltas - pred)
    return _masked_mean(err, pos[..., None].to(err.dtype), count)


def mask_loss(target_masks: torch.Tensor, pred_masks: torch.Tensor,
              target_class_ids: torch.Tensor, count: Count = this_batch) -> torch.Tensor:
    """Binary CE of each positive ROI's target-class mask: target_masks
    [B, T, mh, mw] {0, 1}; pred_masks [B, T, mh, mw, C] sigmoid
    probabilities."""
    pos = target_class_ids > 0
    cls = torch.clamp(target_class_ids, min=0).to(torch.int64)
    b, t, mh, mw, _ = pred_masks.shape
    pred = torch.gather(pred_masks, -1, cls[:, :, None, None, None].expand(b, t, mh, mw, 1))[..., 0]
    p = _clip(pred, 1e-7, 1 - 1e-7)
    ce = -(target_masks * torch.log(p) + (1 - target_masks) * torch.log(1 - p))
    return _masked_mean(ce, pos[:, :, None, None].to(ce.dtype), count)


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of the component losses."""
    return sum(losses.values())
