"""Shaping the output layers of seeded weights so that a random network
detects as a trained one does: a COCO-like number of confident detections
an image, scores spread below 1, boxes refined by a fraction of their size.

A seeded network's outputs are set by the scale of its features: with
unnormalized pixels in, its logits lie tens of units apart, so that every
score saturates at 1.0 (ties that any rounding reorders), and its box
deltas blow boxes up past the image. So the benchmark, after drawing the
weights, runs the reference on one seeded image apart from the timed ones
and rescales the output layers on what it reads there:

- the box-delta kernel ``mrcnn_bbox_fc`` so that the deltas' standard
  deviation is ``delta_std``;
- the mask logits (the last 1×1 conv) to a standard deviation of
  ``mask_logit_std`` over that image's first proposals and every class,
  so that masks are soft and not saturated at 0 or 1;
- the class outputs so that ``over_gate`` candidates of that image clear
  the score gate and the best scores ``top_score``: for each kernel scale
  of a grid (the classes share a softmax), the background bias that lets
  ``over_gate`` ROIs' best foreground class clear the gate, and of those
  the scale whose best score is nearest ``top_score``.

The program and the reference both get the shaped weights.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from perfbench.configs.common import exact_f32
from perfbench.reference import mask_rcnn


def _bisect(count: Callable[[float], int], target: int, lo: float = -500.0,
            hi: float = 500.0) -> float:
    """The bias at which ``count`` (non-increasing in it) comes nearest ``target``."""
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        if count(mid) > target:
            lo = mid
        else:
            hi = mid
    return hi if abs(count(hi) - target) <= abs(count(lo) - target) else lo


def mask_rcnn_heads(p: Dict[str, torch.Tensor], image: torch.Tensor, sizes: dict,
                    rule: dict) -> Dict[str, torch.Tensor]:
    """``p`` with its class logits, box deltas and mask logits shaped on ``image``."""
    gate = sizes["detection_min_threshold"]
    with exact_f32():
        feats, proposals, shared = mask_rcnn.box_features(p, image, sizes)
        shared = shared[0]
        n = sizes["detection_post_nms_instances"]
        xm = mask_rcnn.mask_features(p, feats, proposals[:, :n], sizes)
        mask_kernel = p["mrcnn_mask.mrcnn_mask.weight"]
        mask_logits = torch.einsum("nchw,kc->nhwk", xm, mask_kernel[:, :, 0, 0])
        mask_scale = rule["mask_logit_std"] / float(mask_logits.std())
        w = p["mrcnn.mrcnn_class_logits.weight"]
        raw = shared @ w.T
        base = 1.0 / float(raw[:, 1:].std())
        best = None
        for scale in (base * 2.0 ** (e / 4) for e in range(-8, 33)):
            logits = raw * scale

            def count(background: float, logits=logits):
                probs = torch.softmax(torch.cat([logits[:, :1] + background, logits[:, 1:]],
                                                -1), -1)
                return int((probs[:, 1:].amax(-1) > gate).sum())

            background = _bisect(count, rule["over_gate"])
            probs = torch.softmax(torch.cat([logits[:, :1] + background, logits[:, 1:]], -1), -1)
            top = float(probs[:, 1:].amax())
            if best is None or abs(top - rule["top_score"]) < abs(best[2] - rule["top_score"]):
                best = (scale, background, top)
        deltas = shared @ p["mrcnn.mrcnn_bbox_fc.weight"].T
        box_scale = rule["delta_std"] / float(deltas.std())
    scale, background, _ = best
    bias = torch.zeros_like(p["mrcnn.mrcnn_class_logits.bias"])
    bias[0] = background
    return {**p, "mrcnn.mrcnn_class_logits.weight": w * scale,
            "mrcnn.mrcnn_class_logits.bias": bias,
            "mrcnn.mrcnn_bbox_fc.weight": p["mrcnn.mrcnn_bbox_fc.weight"] * box_scale,
            "mrcnn_mask.mrcnn_mask.weight": mask_kernel * mask_scale}
