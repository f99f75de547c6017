"""Shaping a seeded RetinaNet so that its sigmoid scores spread as a trained
detector's do (the rule of a configuration file's ``seeded_weights``, read
as :mod:`perfbench.shaping` reads Mask R-CNN's).

A seeded network's class logits lie units apart whatever their scale, so
every score would sit near 0 or 1; its box deltas would blow boxes past the
image; and its levels' logits lie apart, so that one level would give every
detection. So, after the weights are drawn, the reference runs on one seeded
image apart from the timed ones and sets, on what it reads there:

- each level's FPN output conv (``fpn_p3`` .. ``fpn_p7``) scaled so that
  the level's ``level_top``-th largest raw class logit equals P3's: every
  level has its share of the best pairs, and so of the detections, as a
  trained RetinaNet's levels share an image's objects. The subnets are
  positively homogeneous (ReLU, zero biases), so scaling a level's features
  by α scales its logits and deltas by α; P7 is a conv of ReLU(P6), so
  ``fpn_p7`` takes α₇ / α₆;
- the box output's kernel, each coordinate's channels apart, so that the
  deltas' standard deviation over every anchor of every level is
  ``delta_std`` (y, x, h, w; its bias 0): boxes move by a tenth of their
  size and grow or shrink by a fifth, at the source's box weights (1, 1, 1,
  1);
- the class output's kernel scale s and one bias b for every class, so that
  the image's best score is t, at least ``p3_over_gate`` (anchor, class)
  pairs of P3 clear the score threshold, and ``over_half`` (a [low, high]
  range) of its detections (the whole decode, NMS included) clear 0.5. For
  each t of ``top_scores`` in turn, b puts the best logit at logit(t) and s
  is the largest that keeps ``p3_over_gate`` pairs of P3 over the
  threshold (the fewer pairs a larger s lets through); the first t whose
  detections over 0.5 then lie in the range is taken. A seeded network's
  raw logits have a heavier upper tail than a trained one's: with the best
  score at 0.95, 1000 pairs of P3 over 0.05 bring 25–80 detections over
  0.5, so t steps down until they are at most ``over_half``'s high end.

:func:`retinanet_outputs` returns the shaped weights and what the image
gave. The program and the reference both get the shaped weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench.configs.common import exact_f32
from perfbench.reference import retinanet
from perfbench.reference.layers import conv

LEVEL_CONVS = ("fpn.fpn_p3", "fpn.fpn_p4", "fpn.fpn_p5", "fpn.fpn_p6", "fpn.fpn_p7")


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


def _outputs(p: Dict[str, torch.Tensor], image: torch.Tensor, sizes: dict):
    """Each level's class logits [1, n_l, C − 1] and box deltas [1, n_l, 4],
    the output convs' biases left out."""
    raw, deltas = [], []
    for f in retinanet.pyramid(p, image, sizes):
        raw.append(retinanet.rows(conv(retinanet.subnet_features(p, f, "class_subnet"),
                                       p["class_subnet.out.weight"], None),
                                  sizes["num_classes"] - 1))
        deltas.append(retinanet.rows(conv(retinanet.subnet_features(p, f, "box_subnet"),
                                          p["box_subnet.out.weight"], None), 4))
    return raw, deltas


def _kth(t: torch.Tensor, k: int) -> float:
    return float(torch.topk(t.reshape(-1), min(k, t.numel())).values[-1])


def _level_scales(raw: List[torch.Tensor], top: int) -> List[float]:
    """Each level's α: P3's ``top``-th largest logit of ``raw`` over the
    level's."""
    kth = [_kth(r, top) for r in raw]
    if min(kth) <= 0:
        raise ValueError(f"sigmoid_shaping: a level's {top}-th logit is not positive: {kth}")
    return [kth[0] / k for k in kth]


def _scaled_levels(p: Dict[str, torch.Tensor], alpha: List[float]) -> Dict[str, torch.Tensor]:
    """``p`` with level l's features scaled by α_l (P7's conv by α₇ / α₆)."""
    shaped = dict(p)
    for name, s in zip(LEVEL_CONVS, alpha[:4] + [alpha[4] / alpha[3]]):
        for part in (".weight", ".bias"):
            shaped[name + part] = p[name + part] * s
    return shaped


def retinanet_outputs(p: Dict[str, torch.Tensor], image: torch.Tensor, sizes: dict,
                      rule: dict) -> Tuple[Dict[str, torch.Tensor], dict]:
    """``p`` with the levels and the class and box outputs shaped on
    ``image`` [1, H, W, 3], and what the image gave: {class scale, bias,
    the best score, P3 pairs over the threshold, detections over 0.5,
    detections, the levels' α, each level's pairs over the threshold and
    its detections}."""
    low, high = rule["over_half"]
    gate = _logit(sizes["score_threshold"])
    with exact_f32():
        alpha = _level_scales(_outputs(p, image, sizes)[0], rule["level_top"])
    p = _scaled_levels(p, alpha)
    with exact_f32():
        raw, deltas = _outputs(p, image, sizes)
        box_scale = torch.tensor(rule["delta_std"]) / torch.cat(deltas, 1)[0].std(0).cpu()
        deltas = [d * box_scale.to(d.device) for d in deltas]
        anchors = retinanet.level_anchors(sizes, image.device)
        best_raw = max(float(r.max()) for r in raw)
        # the p3_over_gate-th largest raw logit of P3 lands just over the threshold
        kth = _kth(raw[0], rule["p3_over_gate"])

        def shaped_at(top: float, scale: float) -> dict:
            bias = _logit(top) - scale * best_raw
            logits = [r * scale + bias for r in raw]
            cands = retinanet.level_candidates(logits, deltas, sizes, anchors)
            _, scores, _, (keep,) = retinanet.merged_keep(cands, sizes)
            ends = torch.tensor([c[1].shape[1] for c in cands], device=keep.device).cumsum(0)
            level = torch.bucketize(keep, ends, right=True)
            score = scores[0, keep]
            return {"scale": scale, "bias": bias, "top_score": float(score.max()),
                    "p3_over_gate": int((logits[0] > gate).sum()),
                    "over_half": int((score > 0.5).sum()), "detections": int(keep.numel()),
                    "level_scale": [round(a, 4) for a in alpha],
                    "level_over_gate": [int((lg > gate).sum()) for lg in logits],
                    "level_detections": torch.bincount(level, minlength=len(cands)).tolist()}

        for top in rule["top_scores"]:
            got = shaped_at(top, (_logit(top) - gate) / (best_raw - kth) * (1.0 - 1e-4))
            if got["over_half"] <= high:
                break
        for _ in range(16):  # fewer than asked: a smaller scale lets more through
            if got["over_half"] >= low:
                break
            got = shaped_at(top, got["scale"] * 2 ** -0.125)
    channel_scale = box_scale.repeat(p["box_subnet.out.weight"].shape[0] // 4)
    shaped = {**p,
              "class_subnet.out.weight": p["class_subnet.out.weight"] * got["scale"],
              "class_subnet.out.bias": torch.full_like(p["class_subnet.out.bias"], got["bias"]),
              "box_subnet.out.weight": p["box_subnet.out.weight"]
              * channel_scale.to(p["box_subnet.out.weight"])[:, None, None, None],
              "box_subnet.out.bias": torch.zeros_like(p["box_subnet.out.bias"])}
    return shaped, got
