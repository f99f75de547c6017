"""Faster R-CNN training: targets, losses and the optimizer step.

Port of ``objectdetection_tpu.faster_rcnn_train``: RPN targets over the ZF
anchor grid and second-stage targets over the proposals, both through
``layers.targets`` with the +1 ZF encoding (anchor matching is the B3
kernel on the card, proposal NMS the B2 kernel), the four losses of
``losses.py``, and SGD with momentum, weight decay and global-norm clipping
at the config's constant rate (``optim.update(constant_lr=True)``).

JAX draws the target sampling noise and the head's dropout masks from its
``jax.random`` keys. The port takes them as tensors (:class:`FasterRCNNNoise`)
and draws them from a ``torch.Generator`` when the caller passes none, as
``detector.TrainNoise`` does for Mask R-CNN. The boxes of this family are
pixel ``(x1, y1, x2, y2)``.

Entry points run on the card unless the caller asks for the CPU:
``create_train_state(config)`` and ``make_train_step(config)`` mean
``device="cuda"`` and raise when there is no card.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import functional_call

from objectdetection_torch import losses as losses_lib
from objectdetection_torch import optim
from objectdetection_torch.config import FasterRCNNConfig
from objectdetection_torch.convert import init_faster_rcnn_params, require_on, resolve_device
from objectdetection_torch.layers.targets import (
    Noise, detection_targets, rpn_targets, uniform_noise,
)
from objectdetection_torch.models.faster_rcnn import (
    DROPOUT_RATE, HIDDEN, ZF_ANCHORS, FasterRCNN, encode_zf_deltas, feature_shape, zf_grid_anchors,
    zf_proposal_layer,
)


class FasterRCNNBatch(NamedTuple):
    images: torch.Tensor  # [B, H, W, 3] float32 (raw or mean-subtracted)
    gt_boxes: torch.Tensor  # [B, G, 4] pixel xyxy, zero-padded
    gt_class_ids: torch.Tensor  # [B, G] int, 0 = padding


class FasterRCNNNoise(NamedTuple):
    """The random draws of one step: target sampling noise (positives,
    negatives) in [0, 1), ``rpn`` [B, A] each and ``detection`` [B, P] each
    (P the training post-NMS budget), and the head's two dropout keep masks
    ``dropout`` [B, T, 1024] bool each (T the sampled ROIs per image)."""

    rpn: Noise
    detection: Noise
    dropout: Tuple[torch.Tensor, torch.Tensor]


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]  # every leaf trains (no BatchNorm)
    opt_state: optim.OptState
    step: int


def num_anchors(config: FasterRCNNConfig) -> int:
    h, w = feature_shape(config.image_shape)
    return h * w * len(ZF_ANCHORS)


def draw_noise(config: FasterRCNNConfig, batch: FasterRCNNBatch,
               generator: Optional[torch.Generator] = None) -> FasterRCNNNoise:
    """The draws a step needs, from ``generator`` (torch's default CPU
    generator if None), on the batch's device."""
    b = batch.images.shape[0]
    dev = batch.images.device
    gen_device = generator.device if generator is not None else "cpu"
    shape = (b, config.train_rois_per_image, HIDDEN)
    keep = tuple((torch.rand(shape, generator=generator, device=gen_device) < 1.0 - DROPOUT_RATE
                  ).to(dev) for _ in range(2))
    return FasterRCNNNoise(
        rpn=uniform_noise((b, num_anchors(config)), generator, dev),
        detection=uniform_noise((b, config.post_nms_top_n_train), generator, dev),
        dropout=keep,
    )


class _Bound(FasterRCNN):
    """FasterRCNN whose forward runs ``fn(module, *args)``: one functional_call
    binds the parameters for every method ``fn`` calls."""

    def forward(self, fn, *args):
        return fn(self, *args)


@functools.lru_cache(maxsize=16)
def _bound_model(config: FasterRCNNConfig) -> _Bound:
    with torch.device("meta"):
        return _Bound(config).eval()


def _losses(model: FasterRCNN, batch: FasterRCNNBatch, config: FasterRCNNConfig,
            noise: FasterRCNNNoise):
    b = batch.images.shape[0]
    feats, rpn_logits, fg_probs, rpn_deltas = model.features_and_rpn(batch.images)
    h, w = feats.shape[1:3]
    anchors = torch.from_numpy(zf_grid_anchors((h, w), config.backbone_stride)).to(feats.device)
    a = anchors.shape[0]
    # targets and proposals carry no gradient
    with torch.no_grad():
        rpn_tgt = rpn_targets(anchors, batch.gt_boxes, batch.gt_class_ids > 0, config,
                              noise.rpn, encode_fn=encode_zf_deltas)
        proposals, _ = zf_proposal_layer(fg_probs, rpn_deltas, config, training=True)
        det_tgt = detection_targets(proposals, batch.gt_boxes, batch.gt_class_ids, config,
                                    noise.detection, encode_fn=encode_zf_deltas)
    logits, _, bbox = model.classify(feats, det_tgt.rois, noise.dropout)
    active = torch.ones((b, config.num_classes), dtype=torch.int64, device=feats.device)
    out = {
        "rpn_class_loss": losses_lib.rpn_class_loss(rpn_tgt.target_class,
                                                    rpn_logits.reshape(b, a, 2)),
        "rpn_box_loss": losses_lib.rpn_box_loss(rpn_tgt.target_deltas,
                                                rpn_deltas.reshape(b, a, 4),
                                                rpn_tgt.target_class),
        "rcnn_class_loss": losses_lib.mrcnn_class_loss(det_tgt.target_class_ids, logits, active),
        "rcnn_box_loss": losses_lib.mrcnn_box_loss(det_tgt.target_deltas, bbox,
                                                   det_tgt.target_class_ids),
    }
    return out, (rpn_tgt, proposals, det_tgt)


def compute_losses(
    params: Dict[str, torch.Tensor],
    batch: FasterRCNNBatch,
    config: FasterRCNNConfig,
    noise: Optional[FasterRCNNNoise] = None,
    generator: Optional[torch.Generator] = None,
    return_targets: bool = False,
):
    """Forward + targets + the four losses. ``noise`` defaults to a draw
    from ``generator``. With ``return_targets`` also returns ``(RPNTargets,
    proposals, DetectionTargets)``."""
    if noise is None:
        noise = draw_noise(config, batch, generator)
    out, targets = functional_call(_bound_model(config), params,
                                   (_losses, batch, config, noise), strict=True)
    return (out, targets) if return_targets else out


def create_train_state(config: FasterRCNNConfig, generator: Optional[torch.Generator] = None,
                       device="cuda") -> TrainState:
    """Random weights from ``init_faster_rcnn_params`` with a fresh optimizer state."""
    params = init_faster_rcnn_params(config, generator, device)
    return TrainState(params, optim.init(params), 0)


def train_step(state: TrainState, batch: FasterRCNNBatch, generator: Optional[torch.Generator],
               config: FasterRCNNConfig, noise: Optional[FasterRCNNNoise] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One SGD step: (new state, metrics: each loss and ``total_loss``)."""
    params, opt_state, metrics, _ = optim.sgd_step(
        state.params, lambda leaves: compute_losses(leaves, batch, config, noise, generator),
        state.opt_state, config, constant_lr=True)
    return TrainState(params, opt_state, state.step + 1), metrics


def make_train_step(config: FasterRCNNConfig, device="cuda"):
    """Returns ``step(state, batch, generator=None, noise=None) -> (state,
    metrics)`` on ``device``. The batch's arrays (numpy or tensors) are moved
    there; the state must already live there."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: FasterRCNNBatch, generator=None,
             noise: Optional[FasterRCNNNoise] = None):
        require_on(dev, state.params, "the train state")
        batch = FasterRCNNBatch(*(torch.as_tensor(x, device=dev) for x in batch))
        return train_step(state, batch, generator, config, noise)

    return step
