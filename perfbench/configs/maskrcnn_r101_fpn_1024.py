"""Mask R-CNN, ResNet-101 + FPN at 1024²: the program's serving state and
call, its backbone prefix and counted work, and the reference beside it.
The system of every configuration whose file names ``maskrcnn_r101_fpn_1024``.

The recipe (the configuration's file): ``precision`` ``int8`` (the
program's int8 serving path: every floating tensor cast to bf16, activation
scales calibrated at ``percentile`` over chunks of ``calib_chunk`` of
``calib_images`` seeded images apart from the timed ones, per input channel
with ``per_channel``, kernels frozen to int8) or ``bf16`` (the cast state
alone). The traffic's ``masks`` runs the mask stage.
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench import counts, shaping, weights
from perfbench.configs.common import backbone_prefix, exact_f32, program_config
from perfbench.reference import mask_rcnn
from perfbench.reference.compare import compare
from perfbench.reference.layers import Precision

# the arithmetic each part of the network runs in, by recipe
KINDS = {
    "int8": {"stem": "bf16", "backbone": "int8", "rpn": "int8", "head": "int8",
             "deconv": "bf16", "float": "f32"},
    "bf16": {"stem": "bf16", "backbone": "bf16", "rpn": "bf16", "head": "bf16",
             "deconv": "bf16", "float": "f32"},
}
CONTROL = {"int8": "int4", "bf16": "fp8"}


class System:
    """The program under test at one seed."""

    def __init__(self, sizes: dict, params: dict, seed: int, device, make_images, log):
        from objectdetection_torch import checkpoint, detector, quant

        self.sizes, self.params, self.device = sizes, params, device
        self.precision = sizes["precision"]
        int8 = self.precision == "int8"
        self.cfg = program_config(sizes, quantized_inference=int8,
                                  per_channel_acts=bool(sizes.get("per_channel", False)),
                                  compute_dtype="bfloat16")
        shaping_rule = sizes["seeded_weights"]
        self.weights = shaping.mask_rcnn_heads(
            weights.make(mask_rcnn.spec(sizes), seed, device, shaping_rule),
            make_images("shaping", 1), sizes, shaping_rule["heads"])
        state = checkpoint.cast_params_for_inference(self.weights)
        if int8:
            model = detector.build_model(self.cfg)
            for k, v in model.state_dict().items():
                if k not in state:  # the int8 scales, filled by calibration
                    state[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
            calib = make_images("calibration", sizes["calib_images"])
            state = quant.freeze_weights(quant.calibrate_variables(
                state, calib, self.cfg, batch_size=sizes["calib_chunk"],
                percentile=float(sizes["percentile"]), device=device))
            del calib
            log(f"int8 state calibrated on {sizes['calib_images']} images")
        self.state = state
        self.masks = bool(params.get("masks", True))
        self.infer = detector.make_infer_fn(self.cfg, with_masks=self.masks, device=device)
        self.model = detector.build_model(self.cfg)
        self.make_images = make_images
        self._int4 = None

    def call(self, images: torch.Tensor, windows: torch.Tensor):
        """The timed call: detections (and masks) copied to the host."""
        d = self.infer(self.state, images, windows)
        det = torch.cat([d.boxes, d.class_ids[..., None].to(torch.float32),
                         d.scores[..., None]], -1)
        return det.cpu().numpy(), (d.masks.float().cpu().numpy() if self.masks else None)

    def backbone(self, images: torch.Tensor):
        return backbone_prefix(self.model, self.state, images, self.cfg)

    def counts(self, batch: int):
        ops = counts.mask_rcnn(self.sizes, batch, KINDS[self.precision])
        return ops if self.masks else [o for o in ops if o.layer != "mask_head"]

    def release(self) -> None:
        """Free the program's state (the reference then runs on a card the
        program no longer holds)."""
        self.state = self.infer = None

    def reference(self, images: torch.Tensor, windows: torch.Tensor, mode: str = "f32",
                  answers=None):
        """The reference's detections and masks on ``images``; given the
        program's ``answers`` for them, also its masks at the answers'
        boxes and classes."""
        at = None if answers is None else torch.from_numpy(answers[0])
        with exact_f32():
            out = mask_rcnn.forward(self.weights, images, windows, self.sizes,
                                    self._precision(mode),
                                    low_stem=self.precision != "int8", at=at)
        return tuple(t.cpu().numpy() for t in out)

    def _precision(self, mode: str) -> Precision:
        """The reference's precision; int4 calibrated as the int8 recipe is
        (the same images, chunks and percentile), once."""
        if mode != "int4" or self.precision != "int8":
            return Precision(mode)
        if self._int4 is None:
            prec = Precision("int4")
            prec.calibrate()
            calib = self.make_images("calibration", self.sizes["calib_images"])
            chunk = self.sizes["calib_chunk"]
            h, w = self.sizes["image_shape"][:2]
            windows = torch.tensor([[0.0, 0.0, float(h), float(w)]],
                                   device=calib.device).repeat(chunk, 1)
            with exact_f32():
                for k in range(0, calib.shape[0], chunk):
                    mask_rcnn.forward(self.weights, calib[k:k + chunk], windows, self.sizes, prec,
                                      low_stem=False)
            prec.freeze(float(self.sizes["percentile"]))
            self._int4 = prec
        return self._int4

    def control_mode(self) -> str:
        return CONTROL[self.precision]

    def compare(self, got, want) -> Dict[str, float]:
        (gd, gm), (wd, _, wm_at) = got, want
        return compare(gd, wd, self.sizes["detection_min_threshold"],
                       gm if self.masks else None, wm_at if self.masks else None)

