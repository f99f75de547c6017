"""Mask R-CNN inference (He et al., arXiv:1703.06870), float32.

ResNet-FPN → RPN (3×3 shared conv, 1×1 objectness and box deltas per
anchor) → proposals (top ``pre_nms`` by objectness, decoded, clipped, NMS
to ``post_nms``) → 7×7 ROIAlign + two 1024-wide fully connected layers →
class softmax and per-class box deltas → detections (argmax class, refined
and clipped to the window, score gate, class-aware NMS, top ``max_dets``)
→ 14×14 ROIAlign + four 3×3 convs, a 2×2 transposed conv and a 1×1 conv →
the detected class's 28×28 sigmoid mask.

``sizes`` is a configuration file's dict (``perfbench/configs``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import backbone
from perfbench.reference.layers import (
    F32, Precision, apply_deltas, clip, conv, dense, frozen_bn, greedy_nms, pyramid_anchors,
    roi_align, stable_desc,
)


def spec(sizes: dict) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every tensor of the network."""
    c = sizes["fpn_channels"]
    k = len(sizes["rpn_anchor_ratios"])
    nc = sizes["num_classes"]
    ph, pw = sizes["pool_shape"]
    yield from backbone.spec("fpn.", sizes["backbone"], c)

    def lin(name, shape, init="lecun"):
        yield name + ".weight", shape, init
        yield name + ".bias", (shape[0],), "zeros"

    def bn(name, n):
        for leaf, init in (("scale", "ones"), ("bias", "zeros"), ("mean", "zeros"),
                           ("var", "ones")):
            yield f"{name}.{leaf}", (n,), init

    yield from lin("rpn_model.rpn_conv_shared", (512, c, 3, 3))
    yield from lin("rpn_model.rpn_class_raw", (2 * k, 512, 1, 1))
    yield from lin("rpn_model.rpn_bbox_pred", (4 * k, 512, 1, 1), "lecun_rpn_deltas")
    yield from lin("mrcnn.mrcnn_class_conv1", (1024, ph * pw * c))
    yield from bn("mrcnn.mrcnn_class_bn1", 1024)
    yield from lin("mrcnn.mrcnn_class_conv2", (1024, 1024))
    yield from bn("mrcnn.mrcnn_class_bn2", 1024)
    yield from lin("mrcnn.mrcnn_class_logits", (nc, 1024))
    yield from lin("mrcnn.mrcnn_bbox_fc", (nc * 4, 1024))
    for i in range(1, 5):
        yield from lin(f"mrcnn_mask.mrcnn_mask_conv{i}", (256, c if i == 1 else 256, 3, 3))
        yield from bn(f"mrcnn_mask.mrcnn_mask_bn{i}", 256)
    yield "mrcnn_mask.mrcnn_mask_deconv.weight", (256, 256, 2, 2), "lecun_transposed"
    yield "mrcnn_mask.mrcnn_mask_deconv.bias", (256,), "zeros"
    yield from lin("mrcnn_mask.mrcnn_mask", (nc, 256, 1, 1))


def anchors(sizes: dict, device) -> torch.Tensor:
    h, w = sizes["image_shape"][:2]
    return torch.from_numpy(pyramid_anchors(
        (h, w), sizes["rpn_anchor_scales"], sizes["rpn_anchor_ratios"],
        sizes["backbone_strides"])).to(device)


def _nchw_to_rows(t: torch.Tensor, b: int, n: int) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).reshape(b, -1, n)


def box_features(p: Dict[str, torch.Tensor], images: torch.Tensor, sizes: dict,
                 prec: Precision = F32, low_stem: bool = True):
    """images [B, H, W, 3] molded → (P2..P5 NHWC, proposals [B, P, 4], the
    box head's shared features [B, P, 1024])."""
    prec.begin()
    dev = images.device
    b = images.shape[0]
    h, w = sizes["image_shape"][:2]
    x = images.permute(0, 3, 1, 2).to(torch.float32) * sizes["input_scale"]
    feats = backbone.resnet_fpn(p, x, "fpn.", sizes["backbone"], prec, low_stem)

    # RPN
    logits, deltas = [], []
    for f in feats:
        s = F.relu(conv(f, p["rpn_model.rpn_conv_shared.weight"],
                        p["rpn_model.rpn_conv_shared.bias"], 1, None, prec, True))
        logits.append(_nchw_to_rows(conv(s, p["rpn_model.rpn_class_raw.weight"],
                                         p["rpn_model.rpn_class_raw.bias"], 1, None, prec,
                                         True), b, 2))
        deltas.append(_nchw_to_rows(conv(s, p["rpn_model.rpn_bbox_pred.weight"],
                                         p["rpn_model.rpn_bbox_pred.bias"], 1, None, prec,
                                         True), b, 4))
    probs = torch.softmax(torch.cat(logits, 1), -1)[..., 1]
    deltas = torch.cat(deltas, 1)

    # proposals
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

    feats_nhwc = [f.permute(0, 2, 3, 1) for f in feats[:4]]

    # box head
    pooled = roi_align(feats_nhwc, proposals, (h, w), tuple(sizes["pool_shape"]))
    xh = pooled.reshape(b, post, -1)
    xh = dense(xh, p["mrcnn.mrcnn_class_conv1.weight"], p["mrcnn.mrcnn_class_conv1.bias"],
               prec, True)
    xh = F.relu(frozen_bn(xh, p, "mrcnn.mrcnn_class_bn1", -1))
    xh = dense(xh, p["mrcnn.mrcnn_class_conv2.weight"], p["mrcnn.mrcnn_class_conv2.bias"],
               prec, True)
    return feats_nhwc, proposals, F.relu(frozen_bn(xh, p, "mrcnn.mrcnn_class_bn2", -1))


def forward(p: Dict[str, torch.Tensor], images: torch.Tensor, windows: torch.Tensor,
            sizes: dict, prec: Precision = F32, low_stem: bool = True,
            at: Optional[torch.Tensor] = None):
    """images [B, H, W, 3] molded, windows [B, 4] pixels → (detections
    [B, N, 6] rows (y1, x1, y2, x2, class, score) zero-padded, masks
    [B, N, 28, 28]); with ``at`` (another side's detection rows [B, M, 6])
    also the masks float32 gives at those boxes and classes."""
    dev = images.device
    b = images.shape[0]
    h, w = sizes["image_shape"][:2]
    post = sizes["post_nms_rois_inference"]
    feats_nhwc, proposals, xh = box_features(p, images, sizes, prec, low_stem)
    cls_probs = torch.softmax(dense(xh, p["mrcnn.mrcnn_class_logits.weight"],
                                    p["mrcnn.mrcnn_class_logits.bias"]), -1)
    nc = cls_probs.shape[-1]
    bbox = dense(xh, p["mrcnn.mrcnn_bbox_fc.weight"], p["mrcnn.mrcnn_bbox_fc.bias"]
                 ).reshape(b, post, nc, 4)

    # detections
    n_out = sizes["detection_post_nms_instances"]
    std = torch.tensor(sizes["bbox_stddev"], device=dev)
    scale = torch.tensor([h - 1, w - 1, h - 1, w - 1], dtype=torch.float32, device=dev)
    shift = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    norm_windows = (windows.to(torch.float32) - shift) / scale
    cls = torch.argmax(cls_probs, -1)
    scores = torch.gather(cls_probs, 2, cls[..., None])[..., 0]
    d = torch.gather(bbox, 2, cls[..., None, None].expand(b, post, 1, 4))[:, :, 0]
    refined = clip(apply_deltas(proposals, d * std), norm_windows[:, None, :])
    det = torch.zeros((b, n_out, 6), device=dev)
    for i in range(b):
        valid = (cls[i] > 0) & (scores[i] > sizes["detection_min_threshold"])
        order = stable_desc(torch.where(valid, scores[i], torch.full_like(scores[i], -np.inf)))
        rows = torch.where(valid[order, None], refined[i, order], torch.zeros_like(refined[i]))
        keep = order[greedy_nms(rows, cls[i, order], sizes["detection_nms_threshold"], n_out)]
        det[i, :len(keep)] = torch.cat([refined[i, keep], cls[i, keep, None].float(),
                                        scores[i, keep, None]], -1)

    masks = mask_head(p, feats_nhwc, det, sizes, prec)
    if at is None:
        return det, masks
    return det, masks, mask_head(p, feats_nhwc, at.to(dev), sizes)


def mask_features(p: Dict[str, torch.Tensor], feats_nhwc, boxes: torch.Tensor, sizes: dict,
                  prec: Precision = F32) -> torch.Tensor:
    """The mask head up to its last conv for boxes [B, N, 4]: [B·N, 256, 28, 28]."""
    b, n = boxes.shape[:2]
    h, w = sizes["image_shape"][:2]
    mh, mw = sizes["mask_pool_shape"]
    mp = roi_align(feats_nhwc, boxes.contiguous(), (h, w), (mh, mw))
    xm = mp.reshape(b * n, mh, mw, -1).permute(0, 3, 1, 2)
    for i in range(1, 5):
        xm = conv(xm, p[f"mrcnn_mask.mrcnn_mask_conv{i}.weight"],
                  p[f"mrcnn_mask.mrcnn_mask_conv{i}.bias"], 1, None, prec, True)
        xm = F.relu(frozen_bn(xm, p, f"mrcnn_mask.mrcnn_mask_bn{i}"))
    return F.relu(F.conv_transpose2d(xm, p["mrcnn_mask.mrcnn_mask_deconv.weight"],
                                     p["mrcnn_mask.mrcnn_mask_deconv.bias"], stride=2))


def mask_head(p: Dict[str, torch.Tensor], feats_nhwc, rows: torch.Tensor, sizes: dict,
              prec: Precision = F32) -> torch.Tensor:
    """The 28² masks of detection rows [B, N, 6] (their boxes and classes)
    from the pyramid P2..P5 NHWC: [B, N, 28, 28]."""
    b, n = rows.shape[:2]
    xm = mask_features(p, feats_nhwc, rows[..., :4], sizes, prec)
    ids = rows[..., 4].reshape(-1).to(torch.int64)
    kern = p["mrcnn_mask.mrcnn_mask.weight"][:, :, 0, 0]
    logit = torch.einsum("nchw,nc->nhw", xm, kern[ids]) + p["mrcnn_mask.mrcnn_mask.bias"][ids][
        :, None, None]
    return torch.sigmoid(logit).reshape(b, n, *logit.shape[1:])
