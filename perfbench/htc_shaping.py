"""Shaping a seeded Hybrid Task Cascade so that it detects as a trained one
does (the rule of a configuration file's ``seeded_weights``, read as
:mod:`perfbench.shaping` reads Mask R-CNN's).

A seeded network's outputs are set by the scale of its features (see
:mod:`perfbench.shaping`). So, after the weights are drawn, the reference
runs on one seeded image apart from the timed ones and sets, on what it
reads there, in the order the network runs:

- the semantic embedding conv scaled so that the semantic feature's
  standard deviation equals P3's (``semantic_to_p3``: their ratio): the
  branch is positively homogeneous (ReLU, zero biases), and a feature far
  smaller than the pyramid's would leave the fusion invisible;
- each stage's box output scaled so that its deltas, over the image's
  proposals, have the standard deviation ``delta_std`` (1) before the
  stage's stds: every stage moves its boxes (by a tenth, a twentieth and a
  thirtieth of their size), and the next stage pools the moved boxes;
- the three class outputs by one kernel scale s and one background bias b
  (each stage's, so the mean's): for each s of a grid, the b that brings
  the image's detections over 0.5 (the whole detection, per-class NMS
  included) nearest ``over_half``, and of those the s whose best score is
  nearest ``top_score``;
- on the image's first ``detection_post_nms_instances`` final boxes, head
  by head: each ``conv_res`` (heads after the first) scaled so that its
  output's standard deviation is ``flow_to_input`` (1) times the pooled
  ROIs' (the trunks shrink what they pass on, and a flow far smaller than
  the head's input would leave it invisible), and each class output so
  that its logits over every class have the standard deviation
  ``mask_logit_std``.

:func:`htc_outputs` returns the shaped weights and what the image gave. The
program and the reference both get the shaped weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.configs.common import exact_f32
from perfbench.reference import htc
from perfbench.reference.layers import conv
from perfbench.shaping import _bisect


def _over_half(probs: torch.Tensor, kills: np.ndarray, present: np.ndarray) -> int:
    """Detections over 0.5: greedy NMS class by class over the ROIs whose
    class scores above 0.5 (at most one class a ROI)."""
    p = probs[:, 1:].cpu().numpy()
    roi, cls = np.nonzero((p > 0.5) & present[:, None])
    n = 0
    for c in np.unique(cls):
        members = roi[cls == c]
        order = members[np.argsort(-p[members, c], kind="stable")]
        sub = kills[np.ix_(order, order)]
        alive = np.ones(len(order), bool)
        for j in range(len(order)):
            if alive[j]:
                n += 1
                alive &= ~sub[j]
    return n


def htc_outputs(p: Dict[str, torch.Tensor], image: torch.Tensor, sizes: dict,
                rule: dict) -> Tuple[Dict[str, torch.Tensor], dict]:
    """``p`` with its semantic embedding, box outputs, class outputs and
    mask outputs shaped on ``image`` [1, H, W, 3]; and what the image gave."""
    p = dict(p)
    info = {}
    with exact_f32():
        feats, proposals = htc.pyramid_and_proposals(p, image, sizes)
        sem = htc.semantic_feature(p, feats, sizes)
        ratio = rule["semantic_to_p3"] * float(feats[1].std()) / float(sem.std())
        p["semantic_head.embedding.weight"] = p["semantic_head.embedding.weight"] * ratio
        info["semantic_scale"] = ratio
        pyramid = [f.permute(0, 2, 3, 1) for f in feats[:4]]
        sem = (sem * ratio).permute(0, 2, 3, 1)
        window = torch.tensor([[[0.0, 0.0, 1.0, 1.0]]], device=image.device)
        valid = (proposals != 0).any(-1)[0]
        rois, raw, scales = proposals, [], []
        for t, stds in enumerate(sizes["stage_stds"]):
            x = htc.pooled(pyramid, sem, rois, sizes, sizes["pool_shape"])
            shared, _, deltas = htc.box_stage(p, t, x)
            scale = rule["delta_std"] / float(deltas[0, valid].std())
            p[f"box_heads.{t}.reg.weight"] = p[f"box_heads.{t}.reg.weight"] * scale
            scales.append(scale)
            raw.append(shared[0, valid] @ p[f"box_heads.{t}.cls.weight"].T)
            rois = htc.decode(rois, deltas * scale, stds, sizes, window)
        info["delta_scales"] = scales
        boxes = rois[0, valid]
        canon = torch.cat([torch.minimum(boxes[:, :2], boxes[:, 2:]),
                           torch.maximum(boxes[:, :2], boxes[:, 2:])], -1)
        kills = (htc.iou(canon, canon) > sizes["detection_nms_threshold"]).cpu().numpy()
        present = (canon != 0).any(-1).cpu().numpy()
        mean = sum(raw) / len(raw)
        base = 1.0 / float(mean[:, 1:].std())
        best = None
        for s in (base * 2.0 ** (e / 4) for e in range(-8, 33)):
            logits = mean * s

            def probs(b: float, logits=logits) -> torch.Tensor:
                return torch.softmax(torch.cat([logits[:, :1] + b, logits[:, 1:]], -1), -1)

            b = _bisect(lambda b: _over_half(probs(b), kills, present), rule["over_half"])
            top = float(probs(b)[:, 1:].amax())
            if best is None or abs(top - rule["top_score"]) < abs(best[2] - rule["top_score"]):
                best = (s, b, top, _over_half(probs(b), kills, present))
        s, b, info["top_score"], info["over_half"] = best
        info["class_scale"], info["background"] = s, b
        for t in range(len(sizes["stage_stds"])):
            p[f"box_heads.{t}.cls.weight"] = p[f"box_heads.{t}.cls.weight"] * s
            bias = torch.zeros_like(p[f"box_heads.{t}.cls.bias"])
            bias[0] = b
            p[f"box_heads.{t}.cls.bias"] = bias
        n = sizes["detection_post_nms_instances"]
        rows = torch.cat([rois[:, :n], torch.ones_like(rois[:, :n, :2])], -1)
        x, ids = htc.mask_input(pyramid, sem, rows, sizes)
        last, flow_scales, mask_scales = None, [], []
        for t in range(len(sizes["stage_stds"])):
            m = f"mask_heads.{t}."
            if last is not None:
                r = F.relu(conv(last, p[m + "conv_res.weight"], p[m + "conv_res.bias"]))
                scale = rule["flow_to_input"] * float(x.std()) / float(r.std())
                p[m + "conv_res.weight"] = p[m + "conv_res.weight"] * scale
                flow_scales.append(scale)
            _, last = htc.mask_head(p, t, x, last, ids)
            y = F.relu(F.conv_transpose2d(last, p[m + "deconv.weight"], p[m + "deconv.bias"],
                                          stride=2))
            logits = torch.einsum("nchw,kc->nhwk", y, p[m + "logits.weight"][:, :, 0, 0])
            scale = rule["mask_logit_std"] / float(logits.std())
            p[m + "logits.weight"] = p[m + "logits.weight"] * scale
            mask_scales.append(scale)
        info["flow_scales"], info["mask_scales"] = flow_scales, mask_scales
    return p, info
