"""What the configurations' ``System`` classes share: the program's
``DetectorConfig`` from a sizes file, the backbone prefix call, and running
the reference with TF32 off."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import torch


def program_config(sizes: dict, **recipe):
    """The program's ``DetectorConfig`` at ``sizes`` (every key that names a
    field), then the recipe's fields."""
    from objectdetection_torch.config import DetectorConfig

    fields = {f.name for f in dataclasses.fields(DetectorConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in sizes.items() if k in fields}
    return DetectorConfig(**kw).replace(**recipe)


def backbone_prefix(model, state: Dict[str, torch.Tensor], images: torch.Tensor, cfg):
    """The program's ResNet-FPN alone (``model.fpn``, P2..P6) on ``images``,
    bound as the full call binds it."""
    from torch.func import functional_call

    from objectdetection_torch.models.mask_rcnn import compute_dtype

    fpn = {k[4:]: v for k, v in state.items() if k.startswith("fpn.")}
    x = images * cfg.input_scale if cfg.input_scale != 1.0 else images
    x = x.permute(0, 3, 1, 2).to(compute_dtype(cfg)).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        return functional_call(model.fpn, fpn, (x,))


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
