"""Hybrid Task Cascade, ResNet-101 + FPN at 1024² (Chen et al.,
arXiv:1901.07518; mmdetection's ``htc_r101_fpn_20e_coco.py``): the
program's serving state and call, its backbone prefix and counted work, and
the reference beside it. The system of every configuration whose file names
``htc_r101_fpn_1024``.

The recipe (the configuration's file): ``precision`` ``bf16``, the
program's cast state (``checkpoint.cast_params_for_inference``): cuDNN's
bf16 convs and the epilogue pass, bf16 fully connected layers, f32 class,
box and mask outputs. The program is ``objectdetection_torch.models.htc`` on
a ``config.HTCConfig``; a program without that class cannot run the
configuration, and set-up stops with an ImportError before any work. The
traffic's ``masks`` is always on here: HTC's masks are half its work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from perfbench import counts_htc, htc_shaping, weights
from perfbench.configs.common import backbone_prefix, exact_f32
from perfbench.reference import htc
from perfbench.reference.compare import compare
from perfbench.reference.layers import Precision

# the arithmetic each part of the network runs in, by recipe (the f32
# outputs are F.linear and einsum in f32, TF32 off for matmuls by default)
KINDS = {"bf16": {"stem": "bf16", "backbone": "bf16", "rpn": "bf16", "semantic": "bf16",
                  "head": "bf16", "deconv": "bf16", "float": "f32"}}
CONTROL = {"bf16": "fp8"}


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def program_config(sizes: dict, **recipe):
    """The program's ``HTCConfig`` at ``sizes`` (every key that names a
    field), then the recipe's fields."""
    from objectdetection_torch.config import HTCConfig

    fields = {f.name for f in dataclasses.fields(HTCConfig)}
    kw = {k: _tuples(v) for k, v in sizes.items() if k in fields}
    return HTCConfig(**kw).replace(**recipe)


class System:
    """The program under test at one seed."""

    def __init__(self, sizes: dict, params: dict, seed: int, device, make_images, log):
        self.cfg = program_config(sizes, compute_dtype="bfloat16")
        from objectdetection_torch import checkpoint
        from objectdetection_torch.models import htc as program

        self.sizes, self.params = sizes, params
        self.precision = sizes["precision"]
        self.weights, shaped = htc_shaping.htc_outputs(
            weights.make(htc.spec(sizes), seed, device, sizes["seeded_weights"]),
            make_images("shaping", 1), sizes, sizes["seeded_weights"])
        log(f"shaped on one image: {shaped}")
        self.state = checkpoint.cast_params_for_inference(self.weights)
        self.infer = program.make_infer_fn(self.cfg, device=device)
        self.model = program.build_model(self.cfg)

    def call(self, images: torch.Tensor, windows: torch.Tensor):
        """The timed call: detections and masks copied to the host."""
        det, masks = self.infer(self.state, images, windows)
        return det.cpu().numpy(), masks.cpu().numpy()

    def backbone(self, images: torch.Tensor):
        return backbone_prefix(self.model, self.state, images, self.cfg)

    def counts(self, batch: int):
        return counts_htc.htc(self.sizes, batch, KINDS[self.precision])

    def release(self) -> None:
        """Free the program's state (the reference then runs on a card the
        program no longer holds)."""
        self.state = self.infer = None

    def reference(self, images: torch.Tensor, windows: torch.Tensor, mode: str = "f32",
                  answers=None):
        """The reference's detections and masks on ``images``, in ``mode``;
        given the program's ``answers`` for them, also its masks at the
        answers' boxes and classes."""
        at = None if answers is None else torch.from_numpy(answers[0])
        with exact_f32():
            out = htc.forward(self.weights, images, windows, self.sizes, Precision(mode), at=at)
        return tuple(t.cpu().numpy() for t in out)

    def control_mode(self) -> str:
        return CONTROL[self.precision]

    def compare(self, got, want) -> Dict[str, float]:
        (gd, gm), (wd, _, wm_at) = got, want
        return compare(gd, wd, self.sizes["score_threshold"], gm, wm_at)
