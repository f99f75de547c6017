"""The training optimizer: SGD with momentum, weight decay and clipping.

Port of ``objectdetection_tpu.detector.make_optimizer``, the optax chain
``clip_by_global_norm`` → ``add_decayed_weights`` → ``sgd(momentum)`` with
its formulas written out (``torch.optim`` and ``clip_grad_norm_`` differ:
the latter adds 1e-6 to the norm, and its momentum dampens):

- clip: ``g`` if ``|g| < max_norm`` else ``(g / |g|) · max_norm``, with
  ``|g|`` the global L2 norm over the trained leaves;
- decay: ``u = g + weight_decay · p``;
- momentum: ``trace = u + momentum · trace``; update ``-lr · trace``.

``lr`` is constant or optax's ``warmup_cosine_decay_schedule(0, peak,
warmup, max(total, warmup + 1))`` at the count of updates taken, computed in
f32 as optax does. ``update(..., constant_lr=True)`` takes
``config.learning_rate`` whatever the schedule: the Faster R-CNN and
RetinaNet steps build a constant-rate chain, and ``FasterRCNNConfig`` has no
``lr_schedule``. With ``train_layers="heads"`` only the FPN laterals and
outputs, the RPN and the ROI heads train: the other leaves get a zero update,
no decay and no trace, and stay out of the clipping norm.

Parameters are dicts of tensors named as in the port's state dict; leaves
are updated together with ``torch._foreach_*`` operations.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from objectdetection_torch.config import DetectorConfig

# checkpoint.HEADS_LAYERS of the JAX package, plus its mask head's modules
HEADS_LAYERS = (
    "fpn_c5p5", "fpn_c4p4", "fpn_c3p3", "fpn_c2p2",
    "fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5",
    "rpn_conv_shared", "rpn_class_raw", "rpn_bbox_pred",
    "mrcnn_class_conv1", "mrcnn_class_bn1",
    "mrcnn_class_conv2", "mrcnn_class_bn2",
    "mrcnn_class_logits", "mrcnn_bbox_fc",
)
MASK_HEAD_LAYERS = (
    "mrcnn_mask_conv1", "mrcnn_mask_bn1", "mrcnn_mask_conv2",
    "mrcnn_mask_bn2", "mrcnn_mask_conv3", "mrcnn_mask_bn3",
    "mrcnn_mask_conv4", "mrcnn_mask_bn4", "mrcnn_mask_deconv",
    "mrcnn_mask",
)
_HEAD_NAMES = frozenset(HEADS_LAYERS + MASK_HEAD_LAYERS)


class OptState(NamedTuple):
    trace: Dict[str, torch.Tensor]  # momentum trace of each trained leaf
    count: int  # updates taken: the learning-rate schedule's step


def trained(name: str, train_layers: str = "all") -> bool:
    """Whether the leaf ``name`` (state-dict name) trains under ``train_layers``."""
    if train_layers == "all":
        return True
    if train_layers != "heads":
        raise ValueError(f"train_layers must be 'all' or 'heads', not {train_layers!r}")
    return any(part in _HEAD_NAMES for part in name.split("."))


def learning_rate(config: DetectorConfig, count: int) -> float:
    """The learning rate of update number ``count`` (0-based), in f32."""
    f32 = np.float32
    if config.lr_schedule != "warmup_cosine":
        return config.learning_rate
    peak = f32(config.learning_rate)
    warmup = config.warmup_steps
    decay_steps = max(config.total_train_steps, warmup + 1) - warmup
    if count < warmup:  # linear_schedule(0, peak, warmup)
        frac = f32(1) - f32(count) / f32(warmup)
        return float(f32(-peak) * frac + peak)
    c = f32(min(count - warmup, decay_steps))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay_steps)))
    return float(peak * cosine)


def init(params: Dict[str, torch.Tensor], train_layers: str = "all") -> OptState:
    """Zero traces for the leaves that train, count 0."""
    return OptState(
        trace={k: torch.zeros_like(v) for k, v in params.items() if trained(k, train_layers)},
        count=0,
    )


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    norms = torch._foreach_norm(tensors)
    return torch.linalg.vector_norm(torch.stack(norms))


def update(
    grads: Dict[str, torch.Tensor],
    state: OptState,
    params: Dict[str, torch.Tensor],
    config: DetectorConfig,
    train_layers: str = "all",
    constant_lr: bool = False,
) -> Tuple[Dict[str, torch.Tensor], OptState]:
    """One optimizer update: (updates of the trained leaves, new state).
    Frozen leaves get no update. ``config`` is any config with the optimizer
    fields; ``constant_lr`` ignores its ``lr_schedule``."""
    names = [k for k in params if trained(k, train_layers)]
    missing = [k for k in names if k not in state.trace]
    if missing:
        raise ValueError(f"optimizer state has no trace for {missing[0]} "
                         f"(built for other train_layers than {train_layers!r}?)")
    g = [grads[k] for k in names]
    g_norm = global_norm(g)
    max_norm = config.gradient_clip_norm
    if not bool(g_norm < max_norm):  # clip (also when the norm is not finite)
        g = torch._foreach_mul(torch._foreach_div(g, g_norm), max_norm)
    u = torch._foreach_add(g, [params[k] for k in names], alpha=config.weight_decay)
    trace = torch._foreach_add(u, [state.trace[k] for k in names],
                               alpha=config.learning_rate_momentum)
    lr = config.learning_rate if constant_lr else learning_rate(config, state.count)
    step = torch._foreach_mul(trace, -lr)
    return dict(zip(names, step)), OptState(dict(zip(names, trace)), state.count + 1)


def sgd_step(
    params: Dict[str, torch.Tensor],
    losses_fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
    state: OptState,
    config: DetectorConfig,
    train_layers: str = "all",
    constant_lr: bool = False,
):
    """Differentiate ``losses_fn(leaves) -> {name: loss}`` with respect to
    ``params`` and take one :func:`update`. Returns (new params, new
    optimizer state, metrics: each loss and their sum ``total_loss``,
    gradients: zeros for a leaf the losses do not reach)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        parts = losses_fn(leaves)
        loss = sum(parts.values())
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    params = {k: v.detach() for k, v in params.items()}
    updates, state = update(grads, state, params, config, train_layers, constant_lr)
    metrics = {k: v.detach() for k, v in parts.items()}
    metrics["total_loss"] = loss.detach()
    return apply_updates(params, updates), state, metrics, grads


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """params + updates (leaves without an update are kept as they are)."""
    names = list(updates)
    new = torch._foreach_add([params[k] for k in names], [updates[k] for k in names])
    out = dict(params)
    out.update(zip(names, new))
    return out
