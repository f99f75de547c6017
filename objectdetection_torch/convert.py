"""Weights for the port: the flax-tree bridge and the port's own initializer.

:func:`flax_to_state_dict` turns the variable tree of
``objectdetection_tpu.detector.init_variables`` (a nested dict of numpy
arrays with ``params`` and ``batch_stats`` collections) into the state dict
of :class:`objectdetection_torch.models.mask_rcnn.MaskRCNN`. Module paths map
one to one (``fpn/resnet/res2a/res2a_branch2a`` → ``fpn.resnet.res2a.
res2a_branch2a``); leaves are renamed and relaid:

- conv ``kernel`` [kh, kw, in, out] (HWIO) → ``weight`` [out, in, kh, kw];
- dense ``kernel`` [in, out] → ``weight`` [out, in]. ``mrcnn_class_conv1``
  keeps its (ph, pw, C) input order: the port flattens NHWC ROIs the same way;
- ``mrcnn_mask_deconv`` (a flax ``ConvTranspose``, which does not flip its
  kernel) [kh, kw, in, out] → [in, out, kh, kw] flipped in both spatial axes,
  the layout ``F.conv_transpose2d`` needs for the same result;
- FrozenBatchNorm ``scale``/``bias``/``mean``/``var`` keep their names (eps
  1e-3 lives in the module);
- the int8 serving path's ``quant`` collection (``act_scale``,
  ``kernel_scale``, ``out_scale``, ``c1_out_scale``, ``shared_scale``,
  ``pooled_box_scale``, ``pooled_mask_scale``) becomes buffers at the same
  module paths, unchanged (the per-position scales of ``mrcnn_class_conv1``
  and ``pooled_box_scale`` keep flax's (ph, pw, C) order, as the port
  flattens); a frozen int8 kernel is relaid like a float one and stays int8;
- the ``stats`` collection of int8 bias correction (JAX's
  ``record_act_means``) becomes ``<module path>.act_mean`` entries, the
  ``means`` of :func:`~objectdetection_torch.quant.apply_bias_correction`
  (no tensor of the network's state dict); flax's ``sow`` leaves a tuple of
  values per module, of which the last counts, as JAX's correction reads it.

:func:`init_params` draws a fresh state dict from a ``torch.Generator`` with
the same initializer families as the flax modules (``he_normal`` for the
stem conv, ``lecun_normal`` for every other kernel, zero biases, BN scale 1
except the zero-init ``bn*_branch2c``); :func:`init_faster_rcnn_params` and
:func:`init_retinanet_params` do the same for the other two families, whose
flax trees (``vgg16``/``rpn``/``fastrcnn``; ``fpn``/``class_subnet``/
``box_subnet``) :func:`flax_to_state_dict` maps by the same rules.

:func:`split_collections` splits a state dict as flax splits its
variables: ``params`` (every weight and bias, and the BatchNorm
``scale``/``bias``) train, ``batch_stats`` (BatchNorm ``mean``/``var``)
stay frozen, and ``quant`` holds the int8 scales.
:func:`train_state_from_flax` carries a JAX ``TrainState`` across, optax's
momentum trace and update count included; any tree shaped like ``params``
(a gradient tree too) relays out through :func:`flax_to_state_dict`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from objectdetection_torch.config import DetectorConfig
from objectdetection_torch.quant import QUANT_LEAVES

_COLLECTIONS = ("params", "batch_stats", "quant", "stats")
_BATCH_STATS = ("mean", "var")  # FrozenBatchNorm leaves of the batch_stats collection
# flax's truncated_normal variance_scaling divides the stddev by the std of
# a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _relayout(path: Tuple[str, ...], arr: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return arr
    if arr.ndim == 2:  # Dense [in, out]
        return arr.T
    if arr.ndim == 4:
        if path[-2] == "mrcnn_mask_deconv":
            return arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        return arr.transpose(3, 2, 0, 1)
    raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {arr.shape}")


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax variable tree (numpy leaves) → port state dict (CPU tensors: f32,
    int8 for frozen kernels)."""
    extra = set(variables) - set(_COLLECTIONS)
    if extra:
        raise NotImplementedError(f"collections {sorted(extra)} are not ported")
    out: Dict[str, torch.Tensor] = {}
    for coll in _COLLECTIONS:
        for path, arr in _walk(variables.get(coll, {})):
            leaf = "weight" if path[-1] == "kernel" else path[-1]
            name = ".".join(path[:-1] + (leaf,))
            if isinstance(arr, (tuple, list)):  # a sown value: the last call's
                arr = arr[-1]
            arr = np.asarray(arr)
            arr = arr if arr.dtype == np.int8 else arr.astype(np.float32)
            out[name] = torch.from_numpy(np.array(_relayout(path, arr), order="C"))
    return out


def split_collections(
    state_dict: Mapping[str, torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """State dict → (params, batch_stats, quant), the flax collections:
    BatchNorm ``mean``/``var`` are batch_stats, the int8 scales quant (empty
    for a float config), every other leaf is a param."""
    params, stats, quant = {}, {}, {}
    for name, t in state_dict.items():
        leaf = name.rsplit(".", 1)[-1]
        (stats if leaf in _BATCH_STATS else quant if leaf in QUANT_LEAVES else params)[name] = t
    return params, stats, quant


def _find_fields(obj: Any, field: str) -> Iterator[Any]:
    """Values of every namedtuple field named ``field`` inside ``obj``."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        if field in obj._fields:
            yield getattr(obj, field)
        for key in obj._fields:
            if key != field:
                yield from _find_fields(getattr(obj, key), field)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _find_fields(v, field)
    elif isinstance(obj, Mapping):
        for v in obj.values():
            yield from _find_fields(v, field)


def _arrays_only(tree: Mapping) -> Dict:
    """Drop the leaves that are no arrays (optax's ``MaskedNode`` of frozen
    leaves) from a nested dict."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            sub = _arrays_only(val)
            if sub:
                out[key] = sub
        elif not isinstance(val, tuple):
            out[key] = val
    return out


def train_state_from_flax(state: Any, train_layers: str = "all"):
    """A JAX ``detector.TrainState`` with numpy leaves (``jax.tree.map(
    np.asarray, state)``) → the port's :class:`~objectdetection_torch.
    detector.TrainState` on the CPU: params and batch_stats relaid out, the
    momentum trace of the trained leaves, optax's update count (the step
    where the chain keeps none) and the step."""
    from objectdetection_torch import optim
    from objectdetection_torch.detector import TrainState

    params = flax_to_state_dict({"params": state.params})
    stats = flax_to_state_dict({"batch_stats": state.batch_stats})
    traces = list(_find_fields(state.opt_state, "trace"))
    if len(traces) != 1:
        raise ValueError(f"expected one momentum trace in the optimizer state, found {len(traces)}")
    trace = flax_to_state_dict({"params": _arrays_only(traces[0])})
    counts = [int(np.asarray(c)) for c in _find_fields(state.opt_state, "count")]
    expect = {k for k in params if optim.trained(k, train_layers)}
    if set(trace) != expect:
        raise ValueError(f"the trace covers {len(trace)} leaves, train_layers="
                         f"{train_layers!r} trains {len(expect)}")
    step = int(np.asarray(state.step))
    return TrainState(params=params, batch_stats=stats,
                      opt_state=optim.OptState(trace=trace, count=counts[0] if counts else step),
                      step=step)


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point; a CUDA request with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def require_on(dev: torch.device, tensors: Mapping[str, torch.Tensor], what: str) -> None:
    """Raise unless every tensor of ``tensors`` lives on ``dev``'s device type."""
    wrong = [k for k, v in tensors.items() if v.device.type != dev.type]
    if wrong:
        raise ValueError(f"{what} must live on {dev}; {wrong[0]} is on "
                         f"{tensors[wrong[0]].device}")


def out_feature_dim(name: str) -> int:
    """The dim of the state-dict tensor ``name`` that flax's kernel keeps
    last (its output features): 1 for the mask head's transposed conv
    ([in, out, kh, kw]), 0 for every other weight ([out, in(, kh, kw)])."""
    return 1 if name.endswith("mrcnn_mask_deconv.weight") else 0


def _fan_in(name: str, shape) -> int:
    return int(np.prod(shape)) // shape[out_feature_dim(name)]


def _draw(module: torch.nn.Module, generator: Optional[torch.Generator], device,
          he: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """``module``'s state dict with every kernel drawn truncated-normal from
    ``generator`` (seed 0 if None), in state-dict order: ``lecun_normal``, or
    ``he_normal`` for the names in ``he``. Biases and BatchNorm leaves keep
    the module's defaults."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    state = module.state_dict()
    for name, t in state.items():
        if not name.endswith(".weight") or t.dim() < 2:
            continue
        gain = 2.0 if name in he else 1.0
        std = math.sqrt(gain / _fan_in(name, t.shape)) / _TRUNC_STD
        torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
    return {k: v.to(dev) for k, v in state.items()}


_STEM = ("fpn.resnet.conv1.weight",)  # the ResNet stem's he_normal kernel


def init_params(
    config: DetectorConfig,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Random f32 Mask R-CNN state dict for ``config``, drawn from a CPU
    ``generator`` (seed 0 if None) and moved to ``device``."""
    from objectdetection_torch.models.mask_rcnn import MaskRCNN

    return _draw(MaskRCNN(config), generator, device, he=_STEM)


def init_faster_rcnn_params(config, generator: Optional[torch.Generator] = None,
                            device="cuda") -> Dict[str, torch.Tensor]:
    """Random f32 Faster R-CNN state dict for a ``FasterRCNNConfig``: every
    conv and dense kernel ``lecun_normal``, zero biases, as the flax modules."""
    from objectdetection_torch.models.faster_rcnn import FasterRCNN

    return _draw(FasterRCNN(config), generator, device)


def init_retinanet_params(config: DetectorConfig, generator: Optional[torch.Generator] = None,
                          device="cuda") -> Dict[str, torch.Tensor]:
    """Random f32 RetinaNet state dict: the backbone as :func:`init_params`
    draws it, the subnets' kernels ``lecun_normal``, zero biases but the
    class output's, which starts at the focal prior −log(99)."""
    from objectdetection_torch.models.retinanet import RetinaNet

    return _draw(RetinaNet(config), generator, device, he=_STEM)
