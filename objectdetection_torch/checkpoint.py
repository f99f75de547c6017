"""Checkpoints, int8 serving artifacts, and matterport-h5 weights for the port.

Port of ``objectdetection_tpu.checkpoint``:

- :func:`save_checkpoint` / :func:`load_checkpoint` persist a
  :class:`~objectdetection_torch.detector.TrainState` (params, batch_stats,
  the optimizer's momentum trace and count, the step) in the port's own
  format: a directory holding ``train_state.pt`` (``torch.save``, read back
  with ``weights_only=True``). JAX's orbax files are not read.
- :func:`save_quantized` / :func:`load_quantized` persist a calibrated and
  frozen int8 state dict (``variables.pt``) with ``quant_meta.json``, whose
  keys and meaning are JAX's: the gates that change the state dict's layout.
- :func:`cast_params_for_inference` casts every floating tensor (BatchNorm
  statistics included) once, as the JAX server does before serving.
- :func:`load_matterport_h5` fills a state dict from a matterport
  ``mask_rcnn_coco.h5``: each tensor is taken to the flax layout by
  :func:`_adapt_shape` (the 7×7 ``mrcnn_class_conv1`` reshaped to a dense,
  the Keras deconv's channel swap and spatial flip), then through
  ``convert._relayout``, the same path a flax tree takes. ``h5py`` is
  imported inside the loader only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from objectdetection_torch.convert import _relayout

_STATE_FILE = "train_state.pt"
_QUANT_FILE = "variables.pt"
_META_FILE = "quant_meta.json"


def save_checkpoint(path: str, state) -> None:
    """Save a :class:`~objectdetection_torch.detector.TrainState` into the
    directory ``path``."""
    os.makedirs(path, exist_ok=True)
    payload = {
        "params": dict(state.params),
        "batch_stats": dict(state.batch_stats),
        "opt_state": {"trace": dict(state.opt_state.trace), "count": int(state.opt_state.count)},
        "step": int(state.step),
    }
    torch.save(payload, os.path.join(path, _STATE_FILE))


def _fit(saved: Mapping[str, torch.Tensor], like: Mapping[str, torch.Tensor], what: str):
    """``saved`` moved onto ``like``'s devices; raises unless the names,
    shapes and dtypes are ``like``'s."""
    missing, extra = sorted(set(like) - set(saved)), sorted(set(saved) - set(like))
    if missing or extra:
        raise ValueError(f"checkpoint {what} does not fit: missing {missing[:3]}, "
                         f"unexpected {extra[:3]}")
    out = {}
    for k, ref in like.items():
        t = saved[k]
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(f"checkpoint {what} does not fit: {k} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {ref.dtype} {tuple(ref.shape)}")
        out[k] = t.to(ref.device)
    return out


def load_checkpoint(path: str, like):
    """Restore a train state saved by :func:`save_checkpoint` with the
    structure (names, shapes, dtypes) and devices of ``like``."""
    from objectdetection_torch import optim
    from objectdetection_torch.detector import TrainState

    saved = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu", weights_only=True)
    opt = saved["opt_state"]
    return TrainState(
        params=_fit(saved["params"], like.params, "params"),
        batch_stats=_fit(saved["batch_stats"], like.batch_stats, "batch_stats"),
        opt_state=optim.OptState(trace=_fit(opt["trace"], like.opt_state.trace, "trace"),
                                 count=int(opt["count"])),
        step=int(saved["step"]),
    )


def save_quantized(path: str, variables: Mapping[str, torch.Tensor], config=None) -> None:
    """Persist a calibrated and frozen int8 state dict (the output of
    ``freeze_weights(calibrate_variables(...))``) into the directory
    ``path``, with ``quant_meta.json`` when ``config`` is given: loading it
    skips calibration at every start."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in variables.items()},
               os.path.join(path, _QUANT_FILE))
    if config is not None:
        # the quantization gates change the state dict's layout (QuantConv
        # against Conv, scalar against [C] scales): persist them so that a
        # loader restores a matching config
        meta = {
            "per_channel_acts": bool(config.per_channel_acts),
            "quantize_rpn": bool(config.quantize_rpn),
            "quantize_box_head": bool(config.quantize_box_head),
            "quantize_mask_head": bool(config.quantize_mask_head),
            "quantize_fpn_p2": bool(config.quantize_fpn_p2),
            "backbone": config.backbone,
            "image_shape": list(config.image_shape),
        }
        with open(os.path.join(path, _META_FILE), "w") as f:
            json.dump(meta, f, indent=1)


def load_quant_meta(path: str) -> Optional[dict]:
    """The gates persisted beside a quantized artifact, or None for an
    artifact saved without them."""
    p = os.path.join(os.path.abspath(path), _META_FILE)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def load_quantized(path: str) -> Dict[str, torch.Tensor]:
    """The state dict saved by :func:`save_quantized`, on the CPU, in the
    saved dtypes (int8 kernels stay int8)."""
    return torch.load(os.path.join(os.path.abspath(path), _QUANT_FILE), map_location="cpu",
                      weights_only=True)


def cast_params_for_inference(variables: Mapping[str, torch.Tensor],
                              dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every floating tensor cast to ``dtype`` once (serving only: a trained
    state keeps f32)."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in variables.items()}


# ---------------------------------------------------------------------------
# matterport h5 → the port's state dict
# ---------------------------------------------------------------------------

_BN_LEAF_MAP = {
    "scale": "gamma:0",
    "bias": "beta:0",
    "mean": "moving_mean:0",
    "var": "moving_variance:0",
}
_CONV_LEAF_MAP = {"kernel": "kernel:0", "bias": "bias:0"}


def _is_bn(layer_name: str) -> bool:
    return layer_name.startswith("bn") or "_bn" in layer_name


def _h5_group(h5, layer_name: str):
    """The h5 group of a layer; the RPN's layers nest under ``rpn_model``."""
    if layer_name.startswith("rpn_"):
        return h5["rpn_model"][layer_name]
    return h5[layer_name][layer_name]


def _flax_shape(layer: str, leaf: str, shape) -> tuple:
    """The flax shape of a port tensor (the inverse of ``convert._relayout``)."""
    if leaf != "kernel":
        return tuple(shape)
    if len(shape) == 2:  # [out, in] → [in, out]
        return (shape[1], shape[0])
    if layer == "mrcnn_mask_deconv":  # [in, out, kh, kw] → [kh, kw, in, out]
        return (shape[2], shape[3], shape[0], shape[1])
    return (shape[2], shape[3], shape[1], shape[0])  # [out, in, kh, kw] → HWIO


def load_matterport_h5(h5_path: str, variables: Mapping[str, torch.Tensor],
                       skip_layers: Optional[list] = None,
                       strict: bool = True) -> Dict[str, torch.Tensor]:
    """A new state dict: ``variables`` with every tensor that has an entry in
    the matterport-format h5 replaced (same dtype and device).

    The layer is each key's second-to-last segment. ``skip_layers`` are left
    as they are (``HEADS_LAYERS`` keeps the heads random, as the reference's
    ``train_nets='heads'``); ``strict`` raises on a missing entry or a shape
    mismatch, otherwise a missing entry is kept and a mismatch zeroed.
    """
    import h5py

    skip = set(skip_layers or [])
    out = dict(variables)
    with h5py.File(h5_path, "r") as h5:
        for name, leaf in variables.items():
            parts = name.split(".")
            if len(parts) < 2 or parts[-2] in skip:
                continue
            layer = parts[-2]
            leaf_name = "kernel" if parts[-1] == "weight" else parts[-1]
            h5_key = (_BN_LEAF_MAP.get(leaf_name) if _is_bn(layer)
                      else _CONV_LEAF_MAP.get(leaf_name))
            if h5_key is None:
                continue
            try:
                val = np.asarray(_h5_group(h5, layer)[h5_key])
            except KeyError:
                if strict:
                    raise KeyError(f"layer {layer!r}/{h5_key} not found in {h5_path}")
                continue
            want = _flax_shape(layer, leaf_name, leaf.shape)
            val = _adapt_shape(layer, leaf_name, val, want, strict)
            val = _relayout(tuple(parts[:-1]) + (leaf_name,), val)
            out[name] = torch.from_numpy(np.array(val, order="C")).to(leaf.dtype).to(leaf.device)
    return out


def _adapt_shape(layer, leaf_name, val, want_shape, strict):
    """h5 tensor layouts → flax layouts."""
    if leaf_name == "kernel":
        if layer == "mrcnn_class_conv1" and val.ndim == 4:
            # 7x7 conv [7, 7, C, 1024] → dense [7·7·C, 1024]
            val = val.reshape(-1, val.shape[-1])
        elif layer == "mrcnn_class_conv2" and val.ndim == 4:
            # 1x1 conv [1, 1, 1024, 1024] → dense [1024, 1024]
            val = val.reshape(val.shape[-2], val.shape[-1])
        elif layer == "mrcnn_mask_deconv":
            # Keras Conv2DTranspose stores (kh, kw, out, in) and flips
            # spatially; flax's ConvTranspose does not: swap and flip
            val = np.transpose(val, (0, 1, 3, 2))[::-1, ::-1]
    if tuple(val.shape) != tuple(want_shape):
        msg = f"shape mismatch for {layer}/{leaf_name}: h5 {val.shape} vs model {want_shape}"
        if strict:
            raise ValueError(msg)
        return np.zeros(want_shape, val.dtype)
    return val


# The reference's 'heads' skip list (load_params.py:86): layers left at
# their random init when fine-tuning the heads on a new dataset.
HEADS_LAYERS = [
    "fpn_c5p5", "fpn_c4p4", "fpn_c3p3", "fpn_c2p2",
    "fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5",
    "rpn_conv_shared", "rpn_class_raw", "rpn_bbox_pred",
    "mrcnn_class_conv1", "mrcnn_class_bn1",
    "mrcnn_class_conv2", "mrcnn_class_bn2",
    "mrcnn_class_logits", "mrcnn_bbox_fc",
]
