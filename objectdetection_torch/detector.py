"""End-to-end API of the port: inference and the training step.

Port of ``objectdetection_tpu.detector``. Inference: :class:`Detections`,
:func:`forward_inference` and :func:`make_infer_fn`. Training:
:class:`TrainBatch`, :func:`compute_losses`, :class:`TrainState`,
:func:`create_train_state`, :func:`train_step` and :func:`make_train_step`.
Parameters are a state dict (from :func:`objectdetection_torch.convert.
init_params` or :func:`~objectdetection_torch.convert.flax_to_state_dict`);
the network is a module built once per config on the ``meta`` device and
called with those tensors through ``torch.func.functional_call``, so
``forward_inference`` is a function of (params, images, windows) and
``compute_losses`` of (params, batch, noise), as in JAX. Training splits the
state dict into the flax collections (``params`` train, BatchNorm
``batch_stats`` do not) and takes gradients with ``torch.autograd.grad``.

Target sampling draws uniform noise (:class:`TrainNoise`); a step draws it
from the ``torch.Generator`` it is given unless the caller passes it, which
is how the tests feed both frameworks the same numbers. A :class:`Sync`
makes :func:`train_step` one process's part of a data- or tensor-parallel
step (``parallel.py``); the default is a single process.

Entry points run on the card unless the caller asks for the CPU:
``make_infer_fn(config)`` and ``make_train_step(config)`` mean
``device="cuda"`` and raise when there is no card.

Int8 serving (``quantized_inference=True``): start from a float state dict
of the quantized config (``init_params`` or a converted flax tree), record
the activation scales with :func:`calibrate_variables`, pre-quantize the
kernels with :func:`freeze_weights`, and serve the result with
``make_infer_fn``. The int8 path is inference only.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import functional_call

from objectdetection_torch import losses as losses_lib
from objectdetection_torch import optim
from objectdetection_torch.anchors import config_anchors
from objectdetection_torch.config import DetectorConfig
from objectdetection_torch.convert import (
    init_params, require_on, resolve_device, split_collections,
)
from objectdetection_torch.layers.proposals import proposal_layer
from objectdetection_torch.layers.targets import (
    Noise, detection_targets, rpn_targets, uniform_noise,
)
from objectdetection_torch.models.mask_rcnn import MaskRCNN
from objectdetection_torch.quant import calibrate_variables, freeze_weights

__all__ = ["Detections", "Sync", "TrainBatch", "TrainNoise", "TrainState", "build_model",
           "calibrate_variables", "check_state", "check_supported", "compute_losses",
           "create_train_state", "draw_noise", "forward_inference", "freeze_weights",
           "init_params", "make_infer_fn", "make_train_step", "train_step"]


class Detections(NamedTuple):
    """Fixed-size detection results for a batch."""

    boxes: torch.Tensor  # [B, N, 4] normalized (y1, x1, y2, x2)
    class_ids: torch.Tensor  # [B, N] int32 (0 = empty slot)
    scores: torch.Tensor  # [B, N]
    valid: torch.Tensor  # [B, N] bool
    masks: Optional[torch.Tensor] = None  # [B, N, 28, 28] predicted-class soft masks


def check_supported(config: DetectorConfig, training: bool = False) -> None:
    """Raise for what the port does not run (no silent float fallback): the
    int8 path serves only, as in JAX (round and clip have no gradient)."""
    if training and config.quantized_inference:
        raise NotImplementedError(
            "quantized_inference is the int8 serving path: training needs the float config"
        )


def check_state(params: Dict[str, torch.Tensor], config: DetectorConfig) -> None:
    """Raise unless ``params`` holds exactly the tensors ``config``'s network
    has, each of its shape (an int8 kernel stands for a frozen weight)."""
    want = build_model(config).state_dict()
    missing, extra = sorted(set(want) - set(params)), sorted(set(params) - set(want))
    if missing or extra:
        raise ValueError(f"state dict does not fit the config: missing {missing[:3]}, "
                         f"unexpected {extra[:3]}")
    for k, v in want.items():
        if tuple(params[k].shape) != tuple(v.shape):
            raise ValueError(f"state dict does not fit the config: {k} has shape "
                             f"{tuple(params[k].shape)}, the network {tuple(v.shape)}")


@functools.lru_cache(maxsize=16)
def build_model(config: DetectorConfig) -> MaskRCNN:
    """The module tree for ``config``, on the meta device (holds no weights)."""
    with torch.device("meta"):
        return MaskRCNN(config).eval()


def forward_inference(
    params: Dict[str, torch.Tensor],
    images: torch.Tensor,
    windows: torch.Tensor,
    config: DetectorConfig,
    with_masks: bool = True,
    return_intermediates: bool = False,
):
    """Full inference on molded images.

    params: state dict on the images' device; images [B, H, W, 3] molded
    (resized, mean-subtracted); windows [B, 4] pixel windows of real content.
    Returns :class:`Detections`, plus a dict of stage outputs with
    ``return_intermediates``.
    """
    check_supported(config)
    check_state(params, config)
    model = build_model(config)
    det, masks, intermediates = functional_call(
        model, params, (images, windows, with_masks, return_intermediates), strict=True
    )
    result = Detections(
        boxes=det[..., :4],
        class_ids=det[..., 4].to(torch.int32),
        scores=det[..., 5],
        valid=det[..., 5] > 0,
        masks=masks,
    )
    if return_intermediates:
        return result, intermediates
    return result


def make_infer_fn(config: DetectorConfig, with_masks: bool = True, device="cuda"):
    """Returns ``infer_fn(params, images, windows) -> Detections`` on ``device``.

    Inputs may be numpy arrays or tensors; they are moved to ``device``.
    ``params`` must already live there: for ``quantized_inference``, the
    state dict from :func:`calibrate_variables` (then best frozen by
    :func:`freeze_weights`).
    """
    check_supported(config)
    dev = resolve_device(device)

    def infer_fn(params, images, windows):
        require_on(dev, params, "params")
        images = torch.as_tensor(images, dtype=torch.float32, device=dev)
        windows = torch.as_tensor(windows, dtype=torch.float32, device=dev)
        with torch.inference_mode():
            return forward_inference(params, images, windows, config, with_masks)

    return infer_fn


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------


class TrainBatch(NamedTuple):
    """One batch of training data, zero-padded to static shapes."""

    images: torch.Tensor  # [B, H, W, 3] molded
    gt_boxes: torch.Tensor  # [B, G, 4] normalized
    gt_class_ids: torch.Tensor  # [B, G] int, 0 = padding
    gt_masks: Optional[torch.Tensor] = None  # [B, G, H, W] or mini-masks [B, G, mh, mw]
    active_class_ids: Optional[torch.Tensor] = None  # [B, num_classes]


class TrainNoise(NamedTuple):
    """Uniform [0, 1) noise of one step's target sampling, (positives,
    negatives) pairs: ``rpn`` [B, A] each, ``detection`` [B, P] each, with P
    the proposals per image (the training budget, plus G with
    ``train_append_gt``)."""

    rpn: Noise
    detection: Noise


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]  # the flax ``params`` collection, trained
    batch_stats: Dict[str, torch.Tensor]  # BatchNorm mean/var, frozen
    opt_state: optim.OptState
    step: int


def draw_noise(config: DetectorConfig, batch: TrainBatch,
               generator: Optional[torch.Generator] = None,
               rows: Optional[int] = None) -> TrainNoise:
    """The noise a step needs, drawn from ``generator``: for ``rows``
    images (a data-parallel step's global batch), by default the batch's."""
    b, g = batch.gt_boxes.shape[:2]
    b = b if rows is None else rows
    p = config.post_nms_rois_training + (g if config.train_append_gt else 0)
    dev = batch.images.device
    return TrainNoise(rpn=uniform_noise((b, config.num_anchors()), generator, dev),
                      detection=uniform_noise((b, p), generator, dev))


class _Bound(MaskRCNN):
    """MaskRCNN whose forward runs ``fn(module, *args)``: one functional_call
    binds the parameters for every method ``fn`` calls (flax's
    ``apply(..., method=...)``)."""

    def forward(self, fn, *args):
        return fn(self, *args)


@functools.lru_cache(maxsize=16)
def _bound_model(config: DetectorConfig) -> _Bound:
    with torch.device("meta"):
        return _Bound(config).eval()


def _losses(model: MaskRCNN, batch: TrainBatch, config: DetectorConfig,
            noise: TrainNoise, with_masks: bool, count: losses_lib.Count):
    cfg = config
    b = batch.images.shape[0]
    dev = batch.images.device
    anchors = torch.from_numpy(config_anchors(cfg)).to(dev)
    feats, rpn_logits, rpn_probs, rpn_deltas = model.extract(batch.images)
    gt_valid = batch.gt_class_ids > 0
    masks = batch.gt_masks if with_masks else None
    # targets and proposals carry no gradient: proposals are inputs of the
    # second stage (JAX stops the gradient there), the RPN learns from its
    # own losses
    with torch.no_grad():
        rpn_tgt = rpn_targets(anchors, batch.gt_boxes, gt_valid, cfg, noise.rpn)
        proposals = proposal_layer(rpn_probs, rpn_deltas, anchors, cfg, training=True)
        if cfg.train_append_gt:
            # [B, P+G, 4]: padded GT rows are zero, so they stay invalid
            gt_rows = torch.where(gt_valid[..., None], batch.gt_boxes,
                                  torch.zeros_like(batch.gt_boxes))
            proposals = torch.cat([proposals, gt_rows], dim=1)
        mini = (masks is not None and cfg.use_mini_mask
                and tuple(masks.shape[2:]) == tuple(cfg.mini_mask_shape))
        det_tgt = detection_targets(proposals, batch.gt_boxes, batch.gt_class_ids, cfg,
                                    noise.detection, gt_masks=masks, masks_are_mini=mini)
    cls_logits, _, bbox = model.classify_rois(feats, det_tgt.rois)
    active = batch.active_class_ids
    if active is None:
        active = torch.ones((b, cfg.num_classes), dtype=torch.int32, device=dev)
    out = {
        "rpn_class_loss": losses_lib.rpn_class_loss(rpn_tgt.target_class, rpn_logits, count),
        "rpn_box_loss": losses_lib.rpn_box_loss(rpn_tgt.target_deltas, rpn_deltas,
                                                rpn_tgt.target_class, count),
        "mrcnn_class_loss": losses_lib.mrcnn_class_loss(det_tgt.target_class_ids, cls_logits,
                                                        active.to(torch.int64), count),
        "mrcnn_box_loss": losses_lib.mrcnn_box_loss(
            det_tgt.target_deltas, bbox, det_tgt.target_class_ids,
            compat_reference=cfg.compat_reference_box_loss, count=count),
    }
    if masks is not None:
        mask_probs = model.predict_masks(feats, det_tgt.rois)  # every class
        out["mask_loss"] = losses_lib.mask_loss(det_tgt.target_masks, mask_probs,
                                                det_tgt.target_class_ids, count)
    return out, (rpn_tgt, proposals, det_tgt)


def compute_losses(
    params: Dict[str, torch.Tensor],
    batch: TrainBatch,
    config: DetectorConfig,
    noise: Optional[TrainNoise] = None,
    generator: Optional[torch.Generator] = None,
    with_masks: bool = False,
    return_targets: bool = False,
    count: losses_lib.Count = losses_lib.this_batch,
):
    """Forward pass + target assignment + every loss.

    params: the whole state dict (params and batch_stats) on the batch's
    device. ``noise`` defaults to a draw from ``generator``. Returns the dict
    of losses, plus ``(RPNTargets, proposals, DetectionTargets)`` with
    ``return_targets``. Masks enter with ``with_masks`` and ``batch.gt_masks``.
    ``count`` maps each loss's denominator (``losses.py``).
    """
    check_supported(config, training=True)
    if noise is None:
        noise = draw_noise(config, batch, generator)
    with_masks = with_masks and batch.gt_masks is not None
    out, targets = functional_call(_bound_model(config), params,
                                   (_losses, batch, config, noise, with_masks, count),
                                   strict=True)
    return (out, targets) if return_targets else out


def create_train_state(config: DetectorConfig, generator: Optional[torch.Generator] = None,
                       train_layers: str = "all", device="cuda") -> TrainState:
    """Random weights from ``init_params``, split into the flax collections,
    with a fresh optimizer state."""
    check_supported(config, training=True)
    params, stats, _ = split_collections(init_params(config, generator, device))
    return TrainState(params, stats, optim.init(params, train_layers), 0)


def _same(x):
    return x


class Sync(NamedTuple):
    """How one process's step joins a data- or tensor-parallel step
    (``parallel.py``); the defaults are a single process's."""

    weights: Callable[[optim.Grads], optim.Grads] = _same  # trained leaves → the forward's
    count: losses_lib.Count = losses_lib.this_batch  # a loss's denominator → the global one
    grads: Callable[[optim.Grads], optim.Grads] = _same  # gradients → summed over processes
    norm: Callable[[optim.Grads], torch.Tensor] = optim.named_norm  # the whole gradient's L2


def train_step(
    state: TrainState,
    batch: TrainBatch,
    generator: Optional[torch.Generator],
    config: DetectorConfig,
    with_masks: bool = False,
    train_layers: str = "all",
    noise: Optional[TrainNoise] = None,
    sync: Sync = Sync(),
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One SGD step: (new state, metrics). Metrics: each loss,
    ``total_loss`` and ``grad_norm/{fpn,rpn_model,mrcnn,mrcnn_mask}``, the
    norm of each head's gradient before clipping."""
    params, opt_state, metrics, grads = optim.sgd_step(
        state.params,
        lambda leaves: compute_losses({**sync.weights(leaves), **state.batch_stats}, batch,
                                      config, noise, generator, with_masks, count=sync.count),
        state.opt_state, config, train_layers, reduce_grads=sync.grads, norm=sync.norm)
    for head in dict.fromkeys(k.split(".")[0] for k in grads):
        metrics[f"grad_norm/{head}"] = sync.norm(
            {k: g for k, g in grads.items() if k.split(".")[0] == head})
    return TrainState(params, state.batch_stats, opt_state, state.step + 1), metrics


def make_train_step(config: DetectorConfig, with_masks: bool = False,
                    train_layers: str = "all", device="cuda"):
    """Returns ``step(state, batch, generator, noise=None) -> (state,
    metrics)`` on ``device``. The batch's arrays (numpy or tensors) are moved
    there; the state must already live there."""
    check_supported(config, training=True)
    dev = resolve_device(device)

    def step(state: TrainState, batch: TrainBatch, generator=None,
             noise: Optional[TrainNoise] = None):
        require_on(dev, state.params, "the train state")
        batch = TrainBatch(*(None if x is None else torch.as_tensor(x, device=dev)
                             for x in batch))
        return train_step(state, batch, generator, config, with_masks, train_layers, noise)

    return step
