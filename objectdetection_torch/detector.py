"""End-to-end inference API of the port.

Port of the inference half of ``objectdetection_tpu.detector``:
:class:`Detections`, :func:`forward_inference` and :func:`make_infer_fn`.
Parameters are a state dict (from :func:`objectdetection_torch.convert.
init_params` or :func:`~objectdetection_torch.convert.flax_to_state_dict`);
the network is a module built once per config on the ``meta`` device and
called with those tensors through ``torch.func.functional_call``, so
``forward_inference`` is a function of (params, images, windows) as in JAX.

Entry points run on the card unless the caller asks for the CPU:
``make_infer_fn(config)`` means ``device="cuda"`` and raises when there is no
card.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import torch
from torch.func import functional_call

from objectdetection_torch.config import DetectorConfig
from objectdetection_torch.convert import init_params, resolve_device
from objectdetection_torch.models.mask_rcnn import MaskRCNN

__all__ = ["Detections", "build_model", "check_supported", "forward_inference",
           "init_params", "make_infer_fn"]


class Detections(NamedTuple):
    """Fixed-size detection results for a batch."""

    boxes: torch.Tensor  # [B, N, 4] normalized (y1, x1, y2, x2)
    class_ids: torch.Tensor  # [B, N] int32 (0 = empty slot)
    scores: torch.Tensor  # [B, N]
    valid: torch.Tensor  # [B, N] bool
    masks: Optional[torch.Tensor] = None  # [B, N, 28, 28] predicted-class soft masks


def check_supported(config: DetectorConfig) -> None:
    """Raise for what the port does not run yet (no silent float fallback)."""
    if config.quantized_inference:
        raise NotImplementedError(
            "quantized_inference (the int8 PTQ path) is not ported yet: ROADMAP item A11"
        )


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
    ``params`` must already live there.
    """
    check_supported(config)
    dev = resolve_device(device)

    def infer_fn(params, images, windows):
        wrong = [k for k, v in params.items() if v.device.type != dev.type]
        if wrong:
            raise ValueError(f"params must live on {dev}; {wrong[0]} is on "
                             f"{params[wrong[0]].device}")
        images = torch.as_tensor(images, dtype=torch.float32, device=dev)
        windows = torch.as_tensor(windows, dtype=torch.float32, device=dev)
        with torch.inference_mode():
            return forward_inference(params, images, windows, config, with_masks)

    return infer_fn
