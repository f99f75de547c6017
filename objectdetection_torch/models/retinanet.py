"""RetinaNet: the single-stage detector on the ResNet + FPN backbone.

Port of ``objectdetection_tpu.models.retinanet``: class and box subnets
(4× conv3×3(256) + relu, then a 3×3 output conv computed in f32) shared over
the pyramid's levels, the sigmoid focal loss, anchor assignment (IoU ≥ 0.5
positive, < 0.4 background, the band between ignored, the best anchor of
each valid GT forced positive) through the B3 kernel on the card, the
losses, the class-aware detection postprocess through the B2 kernel, and the
training step. Inputs carry the batch dimension; boxes are normalized
``(y1, x1, y2, x2)`` as in the Mask R-CNN family, on the anchors of
``anchors.config_anchors``.

Two configurations, one code path. A ``DetectorConfig`` gives the JAX
package's RetinaNet: levels P2–P6, ``len(rpn_anchor_ratios)`` anchors a
location, and a decode that takes each anchor's best class before one top-k
over the image. A ``config.RetinaNetConfig`` gives the published one (Lin et
al., arXiv:1708.02002): levels P3–P7 with P6 and P7 from C5, 9 anchors a
location (class output 720 wide for COCO's 80 classes, box output 36), and
the paper's decode of :func:`retinanet_detections`, level by level over
(anchor, class) pairs.

Entry points run on the card unless the caller asks for the CPU:
:func:`make_infer_fn` and :func:`make_retinanet_train_step`. Weights come
from ``convert.init_retinanet_params`` or a converted flax tree.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from objectdetection_torch import losses as losses_lib
from objectdetection_torch import metrics, optim
from objectdetection_torch.anchors import anchors_per_level_counts, config_anchors
from objectdetection_torch.config import DetectorConfig, RetinaNetConfig
from objectdetection_torch.convert import require_on, resolve_device, split_collections
from objectdetection_torch.geometry import apply_box_deltas, clip_boxes, encode_box_deltas
from objectdetection_torch.layers.proposals import top_k_stable, top_k_stable_nonneg
from objectdetection_torch.models.backbone import Conv, ResNetFPN, prelude
from objectdetection_torch.models.mask_rcnn import compute_dtype
from objectdetection_torch.ops import anchor_match as anchor_match_op
from objectdetection_torch.ops.nms import non_max_suppression

# focal-loss prior: the class outputs start at a foreground probability of 0.01
PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class RetinaSubnet(nn.Module):
    """NCHW level → 4× [conv3×3 + relu] in ``dtype`` → conv3×3 in f32 (NCHW)."""

    def __init__(self, out_channels: int, channels: int = 256, bias_init_value: float = 0.0,
                 dtype: torch.dtype = torch.float32, cin: int = 256):
        super().__init__()
        self.dtype = dtype
        for i in range(4):
            self.add_module(f"conv{i}", Conv(cin if i == 0 else channels, channels, 3))
        self.out = Conv(channels, out_channels, 3)
        with torch.no_grad():
            self.out.bias.fill_(bias_init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(4):
            x = F.relu(self._modules[f"conv{i}"](x))
        return self.out(x.to(torch.float32))


class RetinaNet(nn.Module):
    """images [B, H, W, 3] → class logits [B, A, C − 1] and box deltas
    [B, A, 4], f32, rows in (level, y, x, anchor) order over the config's
    ``fpn_levels``."""

    def __init__(self, config: DetectorConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        dt = compute_dtype(cfg)
        c = cfg.fpn_channels
        k = cfg.num_anchors_per_location
        self.fpn = ResNetFPN(cfg.backbone, c, cfg.image_shape[2], levels=cfg.fpn_levels)
        self.class_subnet = RetinaSubnet(k * (cfg.num_classes - 1), bias_init_value=PRIOR_BIAS,
                                         dtype=dt, cin=c)
        self.box_subnet = RetinaSubnet(k * 4, dtype=dt, cin=c)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        with metrics.span("odtorch.backbone"):
            feats = self.fpn(prelude(images, cfg.input_scale, compute_dtype(cfg)))
        with metrics.span("odtorch.retina_subnets"):
            b = images.shape[0]
            nc = cfg.num_classes - 1  # no background channel (sigmoid head)
            logits, deltas = [], []
            for fm in feats:
                logits.append(self.class_subnet(fm).permute(0, 2, 3, 1).reshape(b, -1, nc))
                deltas.append(self.box_subnet(fm).permute(0, 2, 3, 1).reshape(b, -1, 4))
            return torch.cat(logits, dim=1), torch.cat(deltas, dim=1)


@functools.lru_cache(maxsize=16)
def build_model(config: DetectorConfig) -> RetinaNet:
    """The module tree for ``config``, on the meta device (holds no weights)."""
    with torch.device("meta"):
        return RetinaNet(config).eval()


def apply(params: Dict[str, torch.Tensor], images: torch.Tensor,
          config: DetectorConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits, deltas) for ``images`` with the state dict ``params``."""
    return functional_call(build_model(config), params, (images,), strict=True)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss over logits [B, A, C − 1]; labels [B, A] int (0 bg,
    ≥ 1 a class id); valid [B, A]: the anchors that count. Normalized by the
    count of positive anchors."""
    nc = logits.shape[-1]
    classes = torch.arange(1, nc + 1, device=logits.device)
    # label 0 (and the ignore label −1) give an all-zero row
    onehot = ((labels[..., None] == classes) & (labels > 0)[..., None]).to(logits.dtype)
    p = torch.sigmoid(logits)
    # optax.sigmoid_binary_cross_entropy
    ce = -onehot * F.logsigmoid(logits) - (1.0 - onehot) * F.logsigmoid(-logits)
    p_t = p * onehot + (1 - p) * (1 - onehot)
    a_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    loss = a_t * (1 - p_t) ** gamma * ce
    loss = torch.sum(loss * valid[..., None])
    num_pos = torch.clamp(torch.sum((labels > 0) & valid), min=1)
    return loss / num_pos


class RetinaTargets(NamedTuple):
    labels: torch.Tensor  # [B, A] int32: 0 bg, ≥ 1 class, −1 ignore
    deltas: torch.Tensor  # [B, A, 4]


def retinanet_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_class_ids: torch.Tensor, config: DetectorConfig) -> RetinaTargets:
    """Per-anchor labels and box targets for a batch: anchors [A, 4],
    gt_boxes [B, G, 4], gt_class_ids [B, G] (0 = padding). One anchor-match
    launch for the batch."""
    b, a = gt_boxes.shape[0], anchors.shape[0]
    gt_valid = gt_class_ids > 0
    m = anchor_match_op.anchor_match(anchors, gt_boxes, gt_valid)
    labels = torch.full((b, a), -1, dtype=torch.int32, device=anchors.device)
    labels = torch.where(m.anchor_max < 0.4, 0, labels)
    pos = m.anchor_max >= 0.5
    # the best anchor of each valid GT is positive; an anchor named by a valid
    # and an invalid GT stays forced (scatter-max, not assignment)
    force = torch.zeros((b, a), dtype=torch.int32, device=anchors.device).scatter_reduce(
        1, m.gt_argmax.to(torch.int64), gt_valid.to(torch.int32), reduce="amax") > 0
    pos = pos | force
    argmax = m.anchor_argmax.to(torch.int64)
    matched_cls = torch.gather(gt_class_ids.to(torch.int32), 1, argmax)
    labels = torch.where(pos, matched_cls, labels)
    labels = torch.where(gt_valid.any(dim=1, keepdim=True), labels, torch.clamp(labels, max=0))
    matched_gt = torch.gather(gt_boxes, 1, argmax[..., None].expand(b, a, 4))
    stddev = torch.tensor(config.rpn_bbox_stddev, dtype=torch.float32, device=anchors.device)
    deltas = encode_box_deltas(anchors[None].expand(b, a, 4), matched_gt) / stddev
    deltas = torch.nan_to_num(torch.where(pos[..., None], deltas, torch.zeros_like(deltas)))
    return RetinaTargets(labels=labels, deltas=deltas)


def _losses(logits, deltas, batch, config: DetectorConfig) -> Dict[str, torch.Tensor]:
    anchors = torch.from_numpy(config_anchors(config)).to(logits.device)
    with torch.no_grad():
        tgt = retinanet_targets(anchors, batch.gt_boxes, batch.gt_class_ids, config)
    valid = tgt.labels >= 0
    cls_loss = focal_loss(logits, torch.clamp(tgt.labels, min=0), valid)
    pos = tgt.labels > 0
    err = losses_lib.smooth_l1(tgt.deltas - deltas)
    num_pos = torch.clamp(torch.sum(pos), min=1)
    box_loss = torch.sum(err * pos[..., None]) / (4 * num_pos)
    return {"focal_loss": cls_loss, "box_loss": box_loss}


def retinanet_losses(params: Dict[str, torch.Tensor], batch,
                     config: DetectorConfig) -> Dict[str, torch.Tensor]:
    """``focal_loss`` and ``box_loss`` of a ``detector.TrainBatch`` (boxes
    normalized) with the state dict ``params``."""
    logits, deltas = apply(params, batch.images, config)
    return _losses(logits, deltas, batch, config)


def retinanet_detections(logits: torch.Tensor, deltas: torch.Tensor, config: DetectorConfig,
                         score_threshold: Optional[float] = None,
                         pre_nms: Optional[int] = None) -> torch.Tensor:
    """Detections from logits [B, A, C − 1] and deltas [B, A, 4] → [B, N, 6]
    rows (y1, x1, y2, x2, class, score), zero-padded, N =
    ``detection_post_nms_instances``.

    A ``DetectorConfig`` (the JAX package's decode): the top ``pre_nms``
    (1000) anchors by best class probability (a stable sort), those above
    ``score_threshold`` (0.3) through class-aware NMS in that order.

    A ``RetinaNetConfig`` (the paper's): on each level, every (anchor, class)
    sigmoid score above ``score_threshold`` (the config's 0.05), at most the
    top ``pre_nms`` (the config's ``pre_nms_per_level``, 1000) in a stable
    order (pair index ``anchor · (C − 1) + class − 1`` within the level),
    decoded with ``rpn_bbox_stddev`` and clipped to the image; the levels
    merged, then class-aware NMS at ``detection_nms_threshold`` in a stable
    descending order of score. Under ``metrics.collect`` it counts
    ``retina_decode.candidates`` (the pairs kept into NMS) and
    ``retina_decode.slots`` (B × the levels' caps)."""
    per_level = isinstance(config, RetinaNetConfig)
    if score_threshold is None:
        score_threshold = config.score_threshold if per_level else 0.3
    if pre_nms is None:
        pre_nms = config.pre_nms_per_level if per_level else 1000
    with metrics.span("odtorch.retina_decode"):
        decode = decode_per_level if per_level else decode_best_class
        boxes, scores, classes, valid = decode(logits, deltas, config, score_threshold, pre_nms)
    with metrics.span("odtorch.retina_nms"):
        res = non_max_suppression(boxes, scores, config.detection_post_nms_instances,
                                  config.detection_nms_threshold, valid=valid,
                                  class_ids=classes.to(torch.int32), assume_sorted=not per_level)
        idx = res.indices.clamp(min=0)
        out = torch.cat([
            torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4)),
            torch.gather(classes, 1, idx)[..., None].to(torch.float32),
            torch.gather(scores, 1, idx)[..., None],
        ], dim=-1)
        return torch.where(res.valid[..., None], out, torch.zeros_like(out))


def _decode(anchors, deltas, stddev, ix):
    """The boxes of anchors ``ix`` [B, k] with their deltas, clipped."""
    b, k = ix.shape
    boxes = apply_box_deltas(anchors[ix],
                             torch.gather(deltas, 1, ix[..., None].expand(b, k, 4)) * stddev)
    return clip_boxes(boxes, (0.0, 0.0, 1.0, 1.0))


def decode_best_class(logits, deltas, config, score_threshold, pre_nms):
    """(boxes, scores, classes, valid) [B, k]: the top ``pre_nms`` anchors by
    best class probability, in score order."""
    anchors = torch.from_numpy(config_anchors(config)).to(logits.device)
    stddev = torch.tensor(config.rpn_bbox_stddev, dtype=torch.float32, device=logits.device)
    probs = torch.sigmoid(logits)
    best = probs.amax(dim=-1)
    cls = torch.argmax(probs, dim=-1) + 1
    top, ix = top_k_stable(best, min(pre_nms, logits.shape[1]))
    return _decode(anchors, deltas, stddev, ix), top, torch.gather(cls, 1, ix), \
        top > score_threshold


def decode_per_level(logits, deltas, config, score_threshold, pre_nms):
    """(boxes, scores, classes, valid) [B, Σ k_l]: each level's top
    ``pre_nms`` (anchor, class) pairs, level after level."""
    anchors = torch.from_numpy(config_anchors(config)).to(logits.device)
    stddev = torch.tensor(config.rpn_bbox_stddev, dtype=torch.float32, device=logits.device)
    b, _, nc = logits.shape
    boxes, scores, classes = [], [], []
    start = 0
    for n in anchors_per_level_counts(config):
        probs = torch.sigmoid(logits[:, start:start + n]).reshape(b, n * nc)
        top, pair = top_k_stable_nonneg(probs, min(pre_nms, n * nc))
        boxes.append(_decode(anchors, deltas, stddev, pair // nc + start))
        scores.append(top)
        classes.append(pair % nc + 1)
        start += n
    scores = torch.cat(scores, dim=1)
    valid = scores > score_threshold
    if metrics.collecting():
        metrics.count("retina_decode.candidates", valid.sum())
        metrics.count("retina_decode.slots", valid.numel())
    return torch.cat(boxes, dim=1), scores, torch.cat(classes, dim=1), valid


def make_infer_fn(config: DetectorConfig, score_threshold: Optional[float] = None,
                  device="cuda"):
    """Returns ``infer_fn(params, images) -> detections [B, N, 6]`` on
    ``device`` (:func:`retinanet_detections`; ``score_threshold`` None is
    the config's). ``images`` are moved there; ``params`` must live there."""
    dev = resolve_device(device)

    def infer_fn(params, images):
        with metrics.span("odtorch.infer"):
            require_on(dev, params, "params")
            images = torch.as_tensor(images, dtype=torch.float32, device=dev)
            with torch.inference_mode():
                logits, deltas = apply(params, images, config)
                return retinanet_detections(logits, deltas, config, score_threshold)

    return infer_fn


class RetinaTrainState(NamedTuple):
    params: Dict[str, torch.Tensor]  # trained
    batch_stats: Dict[str, torch.Tensor]  # BatchNorm mean/var, frozen
    opt_state: optim.OptState
    count: int


def make_retinanet_train_step(config: DetectorConfig, device="cuda"):
    """Returns ``(step, init_state)``. ``init_state(state_dict)`` splits a
    state dict on ``device`` into a :class:`RetinaTrainState` with a fresh
    optimizer state; ``step(state, batch) -> (state, metrics)`` takes one
    SGD step (clip, decay, momentum) at the constant rate
    ``config.learning_rate``, whatever ``config.lr_schedule`` says, as the
    JAX step builds its own constant-rate chain. The batch is a
    ``detector.TrainBatch`` (numpy or tensors; masks unread)."""
    dev = resolve_device(device)

    def init_state(state_dict: Dict[str, torch.Tensor]) -> RetinaTrainState:
        params, stats, _ = split_collections(state_dict)
        return RetinaTrainState(params, stats, optim.init(params), 0)

    def step(state: RetinaTrainState, batch):
        require_on(dev, state.params, "the train state")
        batch = type(batch)(*(None if x is None else torch.as_tensor(x, device=dev)
                              for x in batch))
        params, opt_state, metrics, _ = optim.sgd_step(
            state.params,
            lambda leaves: retinanet_losses({**leaves, **state.batch_stats}, batch, config),
            state.opt_state, config, constant_lr=True)
        return RetinaTrainState(params, state.batch_stats, opt_state, state.count + 1), metrics

    return step, init_state
