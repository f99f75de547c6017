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
  1e-3 lives in the module).

:func:`init_params` draws a fresh state dict from a ``torch.Generator`` with
the same initializer families as the flax modules (``he_normal`` for the
stem conv, ``lecun_normal`` for every other kernel, zero biases, BN scale 1
except the zero-init ``bn*_branch2c``).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from objectdetection_torch.config import DetectorConfig

_COLLECTIONS = ("params", "batch_stats")
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
    """Flax variable tree (numpy leaves) → port state dict (CPU f32 tensors)."""
    extra = set(variables) - set(_COLLECTIONS)
    if extra:
        raise NotImplementedError(
            f"collections {sorted(extra)} (int8 quantized trees) are not ported yet: "
            "ROADMAP item A11"
        )
    out: Dict[str, torch.Tensor] = {}
    for coll in _COLLECTIONS:
        for path, arr in _walk(variables.get(coll, {})):
            leaf = "weight" if path[-1] == "kernel" else path[-1]
            name = ".".join(path[:-1] + (leaf,))
            arr = np.array(_relayout(path, np.asarray(arr, np.float32)), order="C")
            out[name] = torch.from_numpy(arr)
    return out


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point; a CUDA request with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _fan_in(name: str, shape) -> int:
    if name.endswith("mrcnn_mask_deconv.weight"):  # [in, out, kh, kw]
        return shape[0] * shape[2] * shape[3]
    return int(np.prod(shape[1:]))  # [out, in(, kh, kw)]


def init_params(
    config: DetectorConfig,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Random f32 state dict for ``config``, drawn from a CPU ``generator``
    (seed 0 if None) and moved to ``device``."""
    from objectdetection_torch.models.mask_rcnn import MaskRCNN

    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    state = MaskRCNN(config).state_dict()
    for name, t in state.items():
        if not name.endswith(".weight") or t.dim() < 2:
            continue  # biases and BN statistics keep the module defaults
        gain = 2.0 if name == "fpn.resnet.conv1.weight" else 1.0
        std = math.sqrt(gain / _fan_in(name, t.shape)) / _TRUNC_STD
        torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
    return {k: v.to(dev) for k, v in state.items()}
