"""Hybrid Task Cascade inference (Chen et al., "Hybrid Task Cascade for
Instance Segmentation", arXiv:1901.07518), float32, step by step as
mmdetection's ``HybridTaskCascadeRoIHead.simple_test`` runs
``configs/htc/htc_r101_fpn_20e_coco.py``:

1. ResNet-FPN P2..P6, the RPN and its proposals;
2. the semantic branch (``FusedSemanticHead``, fusion level 1): each of P2,
   P4, P5, P6 resized bilinearly (corners aligned) to P3's size, a 1×1 conv
   + ReLU a level, summed; 4 × (3×3 conv 256 + ReLU); a 1×1 embedding conv
   + ReLU: the semantic feature (its 183-wide logits serve training only);
3. three box stages: ROIAlign 7² over P2..P5 plus the semantic feature
   pooled at 14² on the same ROIs and average-pooled to 7², two fully
   connected layers of 1024 + ReLU, the class logits and 4 class-agnostic
   deltas decoded at the stage's stds (the log sizes clamped at
   log(1000 / 16)), boxes clipped to the window; stages 1 and 2 refine the
   ROIs the next one pools;
4. detection: the three stages' logits averaged, a softmax, every (ROI,
   class) pair scoring above ``score_threshold`` through NMS class by class
   at ``detection_nms_threshold``, the best ``detection_post_nms_instances``
   of the image; the boxes are stage 3's decode of stage 3's ROIs;
5. three mask heads on the detections' boxes: ROIAlign 14² over P2..P5 plus
   the semantic feature pooled at 14²; head t > 0 first adds a 1×1 conv +
   ReLU (``conv_res``) of head t − 1's trunk output; 4 × (3×3 conv 256 +
   ReLU) (the trunk), a 2×2 stride-2 transposed conv + ReLU, a 1×1 class
   output; the mask is the mean of the heads' sigmoids at the detected
   class.

Departures from mmdetection, each the convention of the program it judges:

- the backbone, RPN and proposals are :mod:`perfbench.reference.mask_rcnn`'s
  (matterport's ResNet and anchors, 6000 → 1000 proposals across the
  levels at IoU 0.7; mmdetection keeps 1000 a level, then 1000), on a
  square canvas;
- ROIAlign is ``tf.image.crop_and_resize`` (corner-aligned samples) on the
  level of the FPN paper's eq. 1 (k0 = 4, canonical 224), and on the one
  semantic map the same sampling; mmcv's RoIAlign is pixel-aligned, averages
  an adaptive number of samples a bin, and maps levels at ``finest_scale``
  56;
- boxes are normalized ``(y1, x1, y2, x2)`` (the ``(h − 1, w − 1)`` scale,
  the far corner shifted by one pixel) and deltas ``(dy, dx, log dh,
  log dw)`` decoded there; mmdetection decodes ``(dx, dy, dw, dh)`` in
  pixels;
- class 0 is the background (mmdetection's last), and the mask heads'
  class output is 81 wide (80 in mmdetection);
- the box head flattens a pooled ROI in (ph, pw, C) order (mmdetection's
  (C, ph, pw): a permutation of the first layer's input);
- per-class NMS keeps ties in a stable order (the lower ROI first), and the
  image's best rows take equal scores in class order; all-zero proposals
  (the proposal layer's padding) give no detection;
- the weights are seeded and shaped (:mod:`perfbench.htc_shaping`), not
  trained; the semantic logits are drawn and not run.

:func:`forward` also takes the cut variants the tests judge the comparison
with (one box stage, no semantic fusion, no mask information flow).
``sizes`` is a configuration file's dict (``perfbench/configs``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import backbone
from perfbench.reference.layers import (
    F32, Precision, apply_deltas, clip, conv, dense, greedy_nms, iou, roi_align, stable_desc,
)
from perfbench.reference.mask_rcnn import _nchw_to_rows, anchors

MASK_CHANNELS = 256


def spec(sizes: dict) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every tensor of the network."""
    c = sizes["fpn_channels"]
    k = len(sizes["rpn_anchor_ratios"])
    nc = sizes["num_classes"]
    ph, pw = sizes["pool_shape"]
    sc = sizes["semantic_channels"]
    fc = sizes["fc_channels"]
    yield from backbone.spec("fpn.", sizes["backbone"], c)

    def lin(name, shape, init="lecun"):
        yield name + ".weight", shape, init
        yield name + ".bias", (shape[0],), "zeros"

    yield from lin("rpn_model.rpn_conv_shared", (512, c, 3, 3))
    yield from lin("rpn_model.rpn_class_raw", (2 * k, 512, 1, 1))
    yield from lin("rpn_model.rpn_bbox_pred", (4 * k, 512, 1, 1), "lecun_rpn_deltas")
    for i in range(len(sizes["backbone_strides"])):
        yield from lin(f"semantic_head.lateral.{i}", (c, c, 1, 1))
    for i in range(sizes["semantic_convs"]):
        yield from lin(f"semantic_head.convs.{i}", (sc, c if i == 0 else sc, 3, 3))
    yield from lin("semantic_head.embedding", (sc, sc, 1, 1))
    yield from lin("semantic_head.logits", (sizes["semantic_classes"], sc, 1, 1))
    for t in range(len(sizes["stage_stds"])):
        yield from lin(f"box_heads.{t}.fc1", (fc, ph * pw * c))
        yield from lin(f"box_heads.{t}.fc2", (fc, fc))
        yield from lin(f"box_heads.{t}.cls", (nc, fc))
        yield from lin(f"box_heads.{t}.reg", (4, fc))
    m = MASK_CHANNELS
    for t in range(len(sizes["stage_stds"])):
        if t > 0:
            yield from lin(f"mask_heads.{t}.conv_res", (m, m, 1, 1))
        for i in range(4):
            yield from lin(f"mask_heads.{t}.convs.{i}", (m, c if i == 0 else m, 3, 3))
        yield f"mask_heads.{t}.deconv.weight", (m, m, 2, 2), "lecun_transposed"
        yield f"mask_heads.{t}.deconv.bias", (m,), "zeros"
        yield from lin(f"mask_heads.{t}.logits", (nc, m, 1, 1))


def _conv(p, name, x, prec, low=True, relu=True):
    y = conv(x, p[name + ".weight"], p[name + ".bias"], 1, None, prec, low)
    return F.relu(y) if relu else y


def pyramid_and_proposals(p: Dict[str, torch.Tensor], images: torch.Tensor, sizes: dict,
                          prec: Precision = F32):
    """images [B, H, W, 3] molded → (P2..P6 NCHW, proposals [B, P, 4]):
    :func:`perfbench.reference.mask_rcnn.box_features`' backbone, RPN and
    proposals."""
    prec.begin()
    dev = images.device
    b = images.shape[0]
    x = images.permute(0, 3, 1, 2).to(torch.float32) * sizes["input_scale"]
    feats = backbone.resnet_fpn(p, x, "fpn.", sizes["backbone"], prec)
    logits, deltas = [], []
    for f in feats:
        s = _conv(p, "rpn_model.rpn_conv_shared", f, prec)
        logits.append(_nchw_to_rows(_conv(p, "rpn_model.rpn_class_raw", s, prec, relu=False),
                                    b, 2))
        deltas.append(_nchw_to_rows(_conv(p, "rpn_model.rpn_bbox_pred", s, prec, relu=False),
                                    b, 4))
    probs = torch.softmax(torch.cat(logits, 1), -1)[..., 1]
    deltas = torch.cat(deltas, 1)
    a = anchors(sizes, dev)
    pre = min(sizes["pre_nms_rois_count"], a.shape[0])
    post = sizes["post_nms_rois_inference"]
    rpn_std = torch.tensor(sizes["rpn_bbox_stddev"], device=dev)
    unit = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    proposals = torch.zeros((b, post, 4), device=dev)
    for i in range(b):
        top = stable_desc(probs[i])[:pre]
        boxes = clip(apply_deltas(a[top], deltas[i, top] * rpn_std), unit)
        keep = greedy_nms(boxes, torch.zeros(pre, dtype=torch.int32, device=dev),
                          sizes["rpn_nms_threshold"], post)
        proposals[i, :len(keep)] = boxes[keep]
    return feats, proposals


def semantic_feature(p: Dict[str, torch.Tensor], feats, sizes: dict,
                     prec: Precision = F32) -> torch.Tensor:
    """P2..P6 NCHW → the semantic feature NCHW at the fusion level's size."""
    k = sizes["semantic_fusion_level"]
    size = tuple(feats[k].shape[-2:])
    x = _conv(p, f"semantic_head.lateral.{k}", feats[k], prec)
    for i, f in enumerate(feats):
        if i != k:
            f = F.interpolate(f, size=size, mode="bilinear", align_corners=True)
            x = x + _conv(p, f"semantic_head.lateral.{i}", f, prec)
    for i in range(sizes["semantic_convs"]):
        x = _conv(p, f"semantic_head.convs.{i}", x, prec)
    return _conv(p, "semantic_head.embedding", x, prec)


def crop_one_map(feat: torch.Tensor, boxes: torch.Tensor, crop) -> torch.Tensor:
    """Corner-aligned bilinear samples of one map: feat NHWC [B, H, W, C] ×
    boxes [B, R, 4] (normalized, inside the map) → [B, R, ph, pw, C]."""
    b, h, w, c = feat.shape
    r = boxes.shape[1]
    ph, pw = crop
    y1, x1, y2, x2 = boxes.to(torch.float32).unbind(-1)

    def axis(p, lo, hi, size):
        steps = torch.arange(p, dtype=torch.float32, device=boxes.device)
        sm1 = torch.tensor(float(size - 1), device=boxes.device)
        coord = lo[..., None] * sm1 + steps * ((hi - lo)[..., None] * sm1
                                               / torch.tensor(float(p - 1), device=boxes.device))
        i0 = torch.floor(coord)
        frac = coord - i0
        i0 = i0.to(torch.int64).clamp(0, size - 1)
        return i0, (i0 + 1).clamp(max=size - 1), frac

    y0i, y1i, wy = axis(ph, y1, y2, h)
    x0i, x1i, wx = axis(pw, x1, x2, w)
    flat = feat.reshape(b, h * w, c)

    def take(yi, xi):
        idx = (yi[..., :, None] * w + xi[..., None, :]).reshape(b, r * ph * pw, 1)
        return torch.gather(flat, 1, idx.expand(b, r * ph * pw, c)).reshape(b, r, ph, pw, c)

    wy_, wx_ = wy[..., :, None, None], wx[..., None, :, None]
    return (take(y0i, x0i) * ((1 - wy_) * (1 - wx_)) + take(y0i, x1i) * ((1 - wy_) * wx_)
            + take(y1i, x0i) * (wy_ * (1 - wx_)) + take(y1i, x1i) * (wy_ * wx_))


def pooled(pyramid_nhwc, semantic_nhwc, boxes: torch.Tensor, sizes: dict, crop,
           fusion: bool = True) -> torch.Tensor:
    """ROIAlign ``crop`` over P2..P5 plus, with ``fusion``, the semantic
    feature pooled at ``mask_pool_shape`` and average-pooled down to ``crop``."""
    h, w = sizes["image_shape"][:2]
    x = roi_align(pyramid_nhwc, boxes.contiguous(), (h, w), tuple(crop))
    if not fusion:
        return x
    s = crop_one_map(semantic_nhwc, boxes, tuple(sizes["mask_pool_shape"]))
    b, r, sh, sw, c = s.shape
    ph, pw = crop
    if (sh, sw) != (ph, pw):
        s = s.permute(0, 1, 4, 2, 3).reshape(b * r, c, sh, sw)
        s = F.adaptive_avg_pool2d(s, (ph, pw)).reshape(b, r, c, ph, pw).permute(0, 1, 3, 4, 2)
    return x + s


def decode(rois: torch.Tensor, deltas: torch.Tensor, stds, sizes: dict,
           window: torch.Tensor) -> torch.Tensor:
    """A stage's boxes: deltas × stds, the log sizes clamped, applied to the
    ROIs, clipped to ``window`` [B, 1, 4]."""
    d = deltas * torch.tensor(stds, dtype=torch.float32, device=deltas.device)
    lim = sizes["max_log_size_delta"]
    d = torch.cat([d[..., :2], d[..., 2:].clamp(-lim, lim)], -1)
    return clip(apply_deltas(rois, d), window)


def box_stage(p: Dict[str, torch.Tensor], t: int, x: torch.Tensor,
              prec: Precision = F32) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage ``t``'s head on pooled ROIs [B, R, ph, pw, C]: (the shared
    1024-wide features, class logits [B, R, K], deltas [B, R, 4])."""
    b, r = x.shape[:2]
    h = x.reshape(b, r, -1)
    h = F.relu(dense(h, p[f"box_heads.{t}.fc1.weight"], p[f"box_heads.{t}.fc1.bias"], prec, True))
    h = F.relu(dense(h, p[f"box_heads.{t}.fc2.weight"], p[f"box_heads.{t}.fc2.bias"], prec, True))
    return (h, dense(h, p[f"box_heads.{t}.cls.weight"], p[f"box_heads.{t}.cls.bias"]),
            dense(h, p[f"box_heads.{t}.reg.weight"], p[f"box_heads.{t}.reg.bias"]))


def box_stages(p: Dict[str, torch.Tensor], pyramid_nhwc, semantic_nhwc, proposals, window,
               sizes: dict, prec: Precision = F32, stages: Optional[int] = None,
               fusion: bool = True) -> List[Tuple[torch.Tensor, ...]]:
    """(ROIs, class logits, deltas, refined boxes) of each stage (the first
    ``stages`` of them)."""
    out, rois = [], proposals
    for t, stds in enumerate(sizes["stage_stds"][:stages]):
        _, logits, deltas = box_stage(p, t, pooled(pyramid_nhwc, semantic_nhwc, rois, sizes,
                                                   sizes["pool_shape"], fusion), prec)
        refined = decode(rois, deltas, stds, sizes, window)
        out.append((rois, logits, deltas, refined))
        rois = refined
    return out


def per_class_detections(boxes: torch.Tensor, probs: torch.Tensor, rows_valid: torch.Tensor,
                         sizes: dict) -> torch.Tensor:
    """One image: boxes [R, 4], class probabilities [R, K] (class 0 the
    background), rows_valid [R] → detections [N, 6]: class by class, the
    pairs over the score threshold in descending score through greedy NMS,
    at most N kept a class; the image's best N of those, best first (equal
    scores in class order, then in the class's order)."""
    n_out = sizes["detection_post_nms_instances"]
    thr, nms_thr = sizes["score_threshold"], sizes["detection_nms_threshold"]
    lo = torch.minimum(boxes[:, :2], boxes[:, 2:])
    hi = torch.maximum(boxes[:, :2], boxes[:, 2:])
    canon = torch.cat([lo, hi], -1)
    kills = (iou(canon, canon) > nms_thr).cpu().numpy()
    present = ((canon != 0).any(-1) & rows_valid).cpu().numpy()
    scores = probs.cpu().numpy()
    rows: List[Tuple[float, int, int]] = []
    for c in range(1, probs.shape[1]):
        s = scores[:, c]
        cand = np.nonzero(present & (s > thr))[0]
        order = cand[np.argsort(-s[cand], kind="stable")]
        alive = np.ones(len(boxes), bool)
        kept = 0
        for i in order:
            if not alive[i]:
                continue
            rows.append((float(s[i]), c, int(i)))
            kept += 1
            if kept == n_out:
                break
            alive &= ~kills[i]
    rows.sort(key=lambda t: -t[0])  # stable: equal scores keep class order
    det = torch.zeros((n_out, 6), device=boxes.device)
    if rows:
        _, cls, idx = (torch.tensor(v, device=boxes.device) for v in zip(*rows[:n_out]))
        det[:len(idx)] = torch.cat([boxes[idx], cls[:, None].float(), probs[idx, cls][:, None]],
                                   -1)
    return det


def mask_input(pyramid_nhwc, semantic_nhwc, rows: torch.Tensor, sizes: dict,
               fusion: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mask heads' input for detection rows [B, N, 6]: (pooled ROIs
    NCHW [B·N, C, 14, 14], class ids [B·N])."""
    b, n = rows.shape[:2]
    x = pooled(pyramid_nhwc, semantic_nhwc, rows[..., :4], sizes, sizes["mask_pool_shape"],
               fusion)
    return x.reshape(b * n, *x.shape[2:]).permute(0, 3, 1, 2), rows[..., 4].reshape(-1).to(
        torch.int64)


def mask_head(p: Dict[str, torch.Tensor], t: int, x: torch.Tensor,
              last: Optional[torch.Tensor], ids: torch.Tensor,
              prec: Precision = F32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head ``t`` on pooled ROIs NCHW (plus ``conv_res`` of ``last``, the
    previous head's trunk output, where given): (its logits [N, 28, 28] at
    ``ids``, its trunk output)."""
    m = f"mask_heads.{t}."
    if last is not None:
        x = x + _conv(p, m + "conv_res", last, prec)
    for i in range(4):
        x = _conv(p, m + f"convs.{i}", x, prec)
    y = F.relu(F.conv_transpose2d(x, p[m + "deconv.weight"], p[m + "deconv.bias"], stride=2))
    kern = p[m + "logits.weight"][:, :, 0, 0]
    logit = torch.einsum("nchw,nc->nhw", y, kern[ids])
    return logit + p[m + "logits.bias"][ids][:, None, None], x


def mask_heads(p: Dict[str, torch.Tensor], pyramid_nhwc, semantic_nhwc, rows: torch.Tensor,
               sizes: dict, prec: Precision = F32, fusion: bool = True, flow: bool = True,
               trunks: Optional[list] = None) -> torch.Tensor:
    """The soft masks [B, N, 28, 28] of detection rows [B, N, 6] (their boxes
    and classes): the mean of the heads' sigmoids at each row's class.
    Without ``flow`` no head reads the one before it."""
    b, n = rows.shape[:2]
    x, ids = mask_input(pyramid_nhwc, semantic_nhwc, rows, sizes, fusion)
    probs, last = 0.0, None
    for t in range(len(sizes["stage_stds"])):
        logit, last = mask_head(p, t, x, last if flow else None, ids, prec)
        if trunks is not None:
            trunks.append(last)
        probs = probs + torch.sigmoid(logit)
    probs = probs / len(sizes["stage_stds"])
    return probs.reshape(b, n, *probs.shape[1:])


def forward(p: Dict[str, torch.Tensor], images: torch.Tensor, windows: torch.Tensor,
            sizes: dict, prec: Precision = F32, at: Optional[torch.Tensor] = None,
            stages: Optional[int] = None, fusion: bool = True, flow: bool = True,
            intermediates: Optional[dict] = None):
    """images [B, H, W, 3] molded, windows [B, 4] pixels → (detections
    [B, N, 6] rows (y1, x1, y2, x2, class, score) zero-padded, masks
    [B, N, 28, 28]); with ``at`` (another side's detection rows [B, M, 6])
    also the masks float32 gives at those boxes and classes. ``stages``,
    ``fusion`` and ``flow`` cut the network (the first ``stages`` box
    stages; no semantic feature in the ROIs; no mask information flow).
    ``intermediates``, a dict, receives ``proposals``, ``semantic`` (NCHW),
    ``stages`` and ``trunks``."""
    h, w = sizes["image_shape"][:2]
    feats, proposals = pyramid_and_proposals(p, images, sizes, prec)
    semantic = semantic_feature(p, feats, sizes, prec)
    pyramid = [f.permute(0, 2, 3, 1) for f in feats[:4]]
    sem = semantic.permute(0, 2, 3, 1)
    scale = torch.tensor([h - 1, w - 1, h - 1, w - 1], dtype=torch.float32, device=images.device)
    shift = torch.tensor([0.0, 0.0, 1.0, 1.0], device=images.device)
    window = ((windows.to(torch.float32) - shift) / scale)[:, None, :]
    out = box_stages(p, pyramid, sem, proposals, window, sizes, prec, stages, fusion)
    probs = torch.softmax(sum(s[1] for s in out) / len(out), -1)
    valid = (proposals != 0).any(-1)
    det = torch.stack([per_class_detections(out[-1][3][i], probs[i], valid[i], sizes)
                       for i in range(images.shape[0])])
    trunks = [] if intermediates is not None else None
    masks = mask_heads(p, pyramid, sem, det, sizes, prec, fusion, flow, trunks)
    if intermediates is not None:
        intermediates.update(proposals=proposals, semantic=semantic, stages=out, trunks=trunks)
    if at is None:
        return det, masks
    return det, masks, mask_heads(p, pyramid, sem, at.to(images.device), sizes, F32, fusion,
                                  flow)
