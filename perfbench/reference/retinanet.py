"""RetinaNet inference (Lin et al., Focal Loss for Dense Object Detection,
arXiv:1708.02002, §4 and its "Inference" paragraph), float32.

ResNet (:mod:`perfbench.reference.backbone`'s stages and blocks) → FPN
P3..P7: 1×1 laterals on C3..C5 with nearest 2× upsampling, 3×3 outputs P3..P5,
P6 a 3×3 stride-2 conv on C5, P7 ReLU then a 3×3 stride-2 conv on P6 → a
class and a box subnet shared over the levels, each 4 × (3×3 conv 256 +
ReLU) and a 3×3 output conv, (C − 1)·A wide for the classes and 4·A for the
boxes, A = 3 octave scales × 3 ratios → on each level, every (anchor, class)
sigmoid score above ``score_threshold``, at most the top
``pre_nms_per_level`` of them, decoded and clipped → the levels merged,
class-aware greedy NMS at ``detection_nms_threshold``, the first
``detection_post_nms_instances`` rows.

Departures from the paper and Detectron's ``retinanet_R-101-FPN``, each
the convention of the program it judges:

- convolutions pad as flax's ``"SAME"`` (at stride 2 the odd row and column
  at the high end; Detectron pads one on every side), BatchNorm is frozen
  with eps 1e-3, and a stage's stride sits on its first 1×1 conv
  (matterport's ResNet; Detectron's is on the 3×3);
- anchors are normalized by ``(h - 1, w - 1)`` with the far corner shifted
  by one pixel, their sides are scale × octave × √ratio exactly (Detectron
  rounds them to whole pixels), and the 9 anchors of a location run in
  (ratio, octave) order with the ratio outer (Detectron puts the octave
  outer);
- box deltas are decoded with ``rpn_bbox_stddev`` (Detectron's box weights,
  (1, 1, 1, 1) in the configuration) in normalized coordinates, and boxes
  are clipped to the whole normalized canvas [0, 1];
- the top pairs of a level are a stable sort's (ties to the lower pair
  index ``anchor · (C − 1) + class − 1``), and one greedy class-aware NMS runs
  over the merged levels in descending score (ties to the lower merged
  index): the rows that per-class NMS and a top-100 by score would keep;
- the weights are seeded and shaped (:mod:`perfbench.sigmoid_shaping`: each
  level's FPN output conv scaled, the subnets' output layers set), not
  trained, and the class output is not started at the prior π = 0.01.

``sizes`` is a configuration file's dict (``perfbench/configs``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import backbone
from perfbench.reference.layers import (
    F32, Precision, apply_deltas, clip, conv, frozen_bn, greedy_nms, max_pool_same, stable_desc,
)

SUBNETS = ("class_subnet", "box_subnet")


def anchors_per_location(sizes: dict) -> int:
    return len(sizes["anchor_octaves"]) * len(sizes["rpn_anchor_ratios"])


def spec(sizes: dict) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every tensor of the network."""
    c = sizes["fpn_channels"]
    a = anchors_per_location(sizes)
    for name, shape, init in backbone.spec("fpn.", sizes["backbone"], c):
        if not name.startswith(("fpn.fpn_c2p2.", "fpn.fpn_p2.")):
            yield name, shape, init

    def conv_(name, co, ci):
        yield name + ".weight", (co, ci, 3, 3), "lecun"
        yield name + ".bias", (co,), "zeros"

    yield from conv_("fpn.fpn_p6", c, 2048)
    yield from conv_("fpn.fpn_p7", c, c)
    for sub, out in zip(SUBNETS, ((sizes["num_classes"] - 1) * a, 4 * a)):
        for i in range(4):
            yield from conv_(f"{sub}.conv{i}", 256, c if i == 0 else 256)
        yield from conv_(f"{sub}.out", out, 256)


def level_anchors(sizes: dict, device) -> List[torch.Tensor]:
    """Each level's normalized anchors [H_l·W_l·A, 4] in (y, x, ratio,
    octave) order."""
    h, w = sizes["image_shape"][:2]
    r = np.asarray(sizes["rpn_anchor_ratios"], dtype=np.float64)[:, None]
    norm, shift = np.array([h - 1, w - 1, h - 1, w - 1]), np.array([0, 0, 1, 1])
    out = []
    for scale, stride in zip(sizes["rpn_anchor_scales"], sizes["backbone_strides"]):
        side = scale * np.asarray(sizes["anchor_octaves"], dtype=np.float64)[None, :]
        hs, ws = (side / np.sqrt(r)).reshape(-1), (side * np.sqrt(r)).reshape(-1)
        fh, fw = -(-h // stride), -(-w // stride)
        cy, cx = np.meshgrid((np.arange(fh) * stride).astype(np.float64),
                             (np.arange(fw) * stride).astype(np.float64), indexing="ij")
        cy, cx = cy[..., None], cx[..., None]
        pix = np.stack(np.broadcast_arrays(cy - 0.5 * hs, cx - 0.5 * ws,
                                           cy + 0.5 * hs, cx + 0.5 * ws), -1).reshape(-1, 4)
        out.append(torch.from_numpy(((pix - shift) / norm).astype(np.float32)).to(device))
    return out


def resnet(p: Dict[str, torch.Tensor], x: torch.Tensor, prefix: str, model: str,
           prec: Precision = F32):
    """x NCHW f32 → (C2, C3, C4, C5): :func:`perfbench.reference.backbone.resnet_fpn`'s
    ResNet (its stem lowered with the rest), without its FPN."""
    r = prefix + "resnet."
    x = conv(x, p[r + "conv1.weight"], p[r + "conv1.bias"], 2, (3, 3, 3, 3), prec, True)
    x = max_pool_same(F.relu(frozen_bn(x, p, r + "bn_conv1")))
    outs = []
    for stage, _, stride, blocks in backbone.stages(model):
        for i in range(blocks):
            blk = f"{stage}{chr(ord('a') + i)}"
            m = f"{r}res{blk}."

            def cbn(y, branch, st=1):
                y = conv(y, p[f"{m}res{blk}_branch{branch}.weight"],
                         p[f"{m}res{blk}_branch{branch}.bias"], st, None, prec, True)
                return frozen_bn(y, p, f"{m}bn{blk}_branch{branch}")

            s = stride if i == 0 else 1
            short = cbn(x, "1", s) if i == 0 else x
            y = F.relu(cbn(x, "2a", s))
            y = F.relu(cbn(y, "2b"))
            x = F.relu(cbn(y, "2c") + short)
        outs.append(x)
    return tuple(outs)


def pyramid(p: Dict[str, torch.Tensor], images: torch.Tensor, sizes: dict,
            prec: Precision = F32) -> List[torch.Tensor]:
    """images [B, H, W, 3] molded → P3..P7 NCHW."""
    prec.begin()
    x = images.permute(0, 3, 1, 2).to(torch.float32) * sizes["input_scale"]
    _, c3, c4, c5 = resnet(p, x, "fpn.", sizes["backbone"], prec)

    def conv_(name, t, stride=1):
        return conv(t, p[f"fpn.{name}.weight"], p[f"fpn.{name}.bias"], stride, None, prec, True)

    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
    m5 = conv_("fpn_c5p5", c5)
    m4 = up(m5) + conv_("fpn_c4p4", c4)
    m3 = up(m4) + conv_("fpn_c3p3", c3)
    p6 = conv_("fpn_p6", c5, 2)
    return [conv_("fpn_p3", m3), conv_("fpn_p4", m4), conv_("fpn_p5", m5), p6,
            conv_("fpn_p7", F.relu(p6), 2)]


def subnet_features(p: Dict[str, torch.Tensor], f: torch.Tensor, sub: str,
                    prec: Precision = F32) -> torch.Tensor:
    """A subnet's four 3×3 convs + ReLU on one level: NCHW, 256 wide."""
    for i in range(4):
        f = F.relu(conv(f, p[f"{sub}.conv{i}.weight"], p[f"{sub}.conv{i}.bias"], 1, None, prec,
                        True))
    return f


def rows(t: torch.Tensor, width: int) -> torch.Tensor:
    """An output conv's NCHW map → [B, H·W·A, width] in (y, x, anchor) order."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, width)


def heads(p: Dict[str, torch.Tensor], images: torch.Tensor, sizes: dict,
          prec: Precision = F32) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Each level's class logits [B, n_l, C − 1] and box deltas [B, n_l, 4];
    the output convs run in float32 whatever ``prec`` (as the program's do)."""
    logits, deltas = [], []
    for f in pyramid(p, images, sizes, prec):
        for sub, out, width in zip(SUBNETS, (logits, deltas), (sizes["num_classes"] - 1, 4)):
            x = subnet_features(p, f, sub, prec)
            out.append(rows(conv(x, p[f"{sub}.out.weight"], p[f"{sub}.out.bias"]), width))
    return logits, deltas


def level_candidates(logits: List[torch.Tensor], deltas: List[torch.Tensor], sizes: dict,
                     anchors: List[torch.Tensor]):
    """Each level's top ``pre_nms_per_level`` (anchor, class) pairs by
    sigmoid score, a stable sort: [(boxes [B, k, 4], scores [B, k], classes
    [B, k]), ...], boxes decoded and clipped to [0, 1]."""
    dev = logits[0].device
    std = torch.tensor(sizes["rpn_bbox_stddev"], dtype=torch.float32, device=dev)
    unit = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    out = []
    for lg, dl, an in zip(logits, deltas, anchors):
        b, _, nc = lg.shape
        probs = torch.sigmoid(lg).reshape(b, -1)
        pair = stable_desc(probs)[:, :min(sizes["pre_nms_per_level"], probs.shape[1])]
        a = pair // nc
        d = torch.gather(dl, 1, a[..., None].expand(*a.shape, 4))
        out.append((clip(apply_deltas(an[a], d * std), unit), torch.gather(probs, 1, pair),
                    pair % nc + 1))
    return out


def merged_keep(candidates, sizes: dict):
    """The levels' candidates merged: (boxes [B, M, 4], scores [B, M], classes
    [B, M], the merged indices NMS keeps in each image, best first)."""
    boxes, scores, classes = (torch.cat(t, 1) for t in zip(*candidates))
    keeps = []
    for i in range(boxes.shape[0]):
        valid = scores[i] > sizes["score_threshold"]
        order = stable_desc(torch.where(valid, scores[i], torch.full_like(scores[i], -np.inf)))
        table = torch.where(valid[order, None], boxes[i, order], torch.zeros_like(boxes[i]))
        keeps.append(order[greedy_nms(table, classes[i, order], sizes["detection_nms_threshold"],
                                      sizes["detection_post_nms_instances"])])
    return boxes, scores, classes, keeps


def detect(candidates, sizes: dict) -> torch.Tensor:
    """The levels' candidates merged → detections [B, N, 6] rows (y1, x1,
    y2, x2, class, score), zero-padded."""
    boxes, scores, classes, keeps = merged_keep(candidates, sizes)
    det = torch.zeros((boxes.shape[0], sizes["detection_post_nms_instances"], 6),
                      device=boxes.device)
    for i, keep in enumerate(keeps):
        det[i, :len(keep)] = torch.cat([boxes[i, keep], classes[i, keep, None].float(),
                                        scores[i, keep, None]], -1)
    return det


def forward(p: Dict[str, torch.Tensor], images: torch.Tensor, sizes: dict,
            prec: Precision = F32) -> torch.Tensor:
    """images [B, H, W, 3] molded → detections [B, N, 6]."""
    logits, deltas = heads(p, images, sizes, prec)
    anchors = level_anchors(sizes, images.device)
    return detect(level_candidates(logits, deltas, sizes, anchors), sizes)
