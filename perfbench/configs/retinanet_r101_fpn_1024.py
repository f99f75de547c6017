"""RetinaNet, ResNet-101 + FPN P3..P7 at 1024², as published (Lin et al.,
arXiv:1708.02002): the program's serving state and call, its backbone prefix
and counted work, and the reference beside it. The system of every
configuration whose file names ``retinanet_r101_fpn_1024``.

The recipe (the configuration's file): ``precision`` ``bf16``, the program's
cast state (``checkpoint.cast_params_for_inference``): cuDNN's bf16 convs
up to the subnets' f32 output convs. The program is
``objectdetection_torch.models.retinanet`` on a ``config.RetinaNetConfig``;
a program without that class (before the published RetinaNet) cannot run
the configuration, and set-up stops with an ImportError. The traffic's
windows are the whole canvas, where the program clips its boxes, so the
call does not read them; the job asks for no masks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from perfbench import counts_retinanet, sigmoid_shaping, weights
from perfbench.configs.common import backbone_prefix, exact_f32
from perfbench.reference import retinanet
from perfbench.reference.compare import compare
from perfbench.reference.layers import Precision

# the arithmetic each part of the network runs in, by recipe; the output
# convs take f32 inputs, which cuDNN multiplies in TF32
# (torch.backends.cudnn.allow_tf32 is on by default)
KINDS = {"bf16": {"stem": "bf16", "backbone": "bf16", "subnet": "bf16", "output": "tf32"}}
CONTROL = {"bf16": "fp8"}


def program_config(sizes: dict, **recipe):
    """The program's ``RetinaNetConfig`` at ``sizes`` (every key that names
    a field), then the recipe's fields."""
    from objectdetection_torch.config import RetinaNetConfig

    fields = {f.name for f in dataclasses.fields(RetinaNetConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in sizes.items() if k in fields}
    return RetinaNetConfig(**kw).replace(**recipe)


class System:
    """The program under test at one seed."""

    def __init__(self, sizes: dict, params: dict, seed: int, device, make_images, log):
        from objectdetection_torch import checkpoint
        from objectdetection_torch.models import retinanet as program

        self.sizes, self.params = sizes, params
        self.precision = sizes["precision"]
        self.cfg = program_config(sizes, compute_dtype="bfloat16")
        self.weights, shaped = sigmoid_shaping.retinanet_outputs(
            weights.make(retinanet.spec(sizes), seed, device, {}), make_images("shaping", 1),
            sizes, sizes["seeded_weights"])
        log(f"shaped on one image: {shaped}")
        self.state = checkpoint.cast_params_for_inference(self.weights)
        self.infer = program.make_infer_fn(self.cfg, device=device)
        self.model = program.build_model(self.cfg)

    def call(self, images: torch.Tensor, windows: torch.Tensor):
        """The timed call: detections copied to the host."""
        return (self.infer(self.state, images).cpu().numpy(),)

    def backbone(self, images: torch.Tensor):
        return backbone_prefix(self.model, self.state, images, self.cfg)

    def counts(self, batch: int):
        return counts_retinanet.retinanet(self.sizes, batch, KINDS[self.precision])

    def release(self) -> None:
        """Free the program's state (the reference then runs on a card the
        program no longer holds)."""
        self.state = self.infer = None

    def reference(self, images: torch.Tensor, windows: torch.Tensor, mode: str = "f32",
                  answers=None):
        """The reference's detections on ``images``, in ``mode``."""
        with exact_f32():
            det = retinanet.forward(self.weights, images, self.sizes, Precision(mode))
        return (det.cpu().numpy(),)

    def control_mode(self) -> str:
        return CONTROL[self.precision]

    def compare(self, got, want) -> Dict[str, float]:
        return compare(got[0], want[0], self.sizes["score_threshold"])
