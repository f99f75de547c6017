"""Faster R-CNN (VGG16 + ZF anchors): the second detector family.

Port of ``objectdetection_tpu.models.faster_rcnn``: the ZF anchor table and
its shifted grid, the legacy +1 box encoding, the single-level RPN, the
proposal layer (decode, clip, min-size filter, top-k, NMS through the B2
kernel on the card), the Fast R-CNN head and the class-aware detection
postprocess. Inputs carry the batch dimension (JAX maps per image).

Conventions of this family, kept from JAX: boxes are pixel
``(x1, y1, x2, y2)``; widths and heights count +1; the head normalizes ROIs
by the image size (not size − 1) before its 14×14 ``crop_and_resize`` and a
2×2/2 max pool to 7×7. The family computes in f32 (``FasterRCNNConfig``
has no compute dtype; the modules keep JAX's ``dtype`` argument).

Entry points: :func:`apply` runs the network as a function of a state dict
(``init_faster_rcnn_params`` or a converted flax tree), and
:func:`make_infer_fn` serves it with the detections, on the card unless the
caller asks for the CPU. Training is :mod:`objectdetection_torch.faster_rcnn_train`.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from objectdetection_torch.config import FasterRCNNConfig
from objectdetection_torch.convert import require_on, resolve_device
from objectdetection_torch.layers.proposals import top_k_stable
from objectdetection_torch.models.backbone import Conv
from objectdetection_torch.models.heads import Dense
from objectdetection_torch.models.vgg16 import VGG16
from objectdetection_torch.ops.nms import non_max_suppression
from objectdetection_torch.ops.roi_align import crop_and_resize

# Shaoqing's ZF-net anchors, (x1, y1, x2, y2)
ZF_ANCHORS = np.array(
    [
        [-84.0, -40.0, 99.0, 55.0],
        [-176.0, -88.0, 191.0, 103.0],
        [-360.0, -184.0, 375.0, 199.0],
        [-56.0, -56.0, 71.0, 71.0],
        [-120.0, -120.0, 135.0, 135.0],
        [-248.0, -248.0, 263.0, 263.0],
        [-36.0, -80.0, 51.0, 95.0],
        [-80.0, -168.0, 95.0, 183.0],
        [-168.0, -344.0, 183.0, 359.0],
    ],
    np.float32,
)
VGG16_STRIDE = 16  # four 2×2/2 pools
HEAD_CROP = 14  # the head crops 14×14 and max-pools to 7×7
HIDDEN = 1024  # width of fc1 / fc2
DROPOUT_RATE = 0.5  # after fc1 and fc2, in training


def feature_shape(image_shape) -> Tuple[int, int]:
    """VGG16's map size for an image: each "SAME" pool rounds up."""
    h, w = image_shape[:2]
    return -(-h // VGG16_STRIDE), -(-w // VGG16_STRIDE)


def zf_grid_anchors(feature_hw: Tuple[int, int], stride: int) -> np.ndarray:
    """All shifted ZF anchors [H·W·9, 4] in (x1, y1, x2, y2) pixels: shifts in
    (y, x) row-major order, the 9 shapes innermost."""
    h, w = feature_hw
    sx, sy = np.meshgrid(np.arange(w) * stride, np.arange(h) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    anchors = ZF_ANCHORS[None, :, :] + shifts[:, None, :]
    return anchors.reshape(-1, 4).astype(np.float32)


def _center_form(boxes: torch.Tensor):
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return w, h, boxes[..., 0] + w / 2.0, boxes[..., 1] + h / 2.0


def encode_zf_deltas(boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """(dx, dy, log dw, log dh) taking ``boxes`` onto ``gt_boxes`` (+1 sizes):
    [..., 4] xyxy each. The inverse of :func:`decode_zf_deltas`."""
    bw, bh, bcx, bcy = _center_form(boxes)
    gw, gh, gcx, gcy = _center_form(gt_boxes)
    return torch.stack([(gcx - bcx) / bw, (gcy - bcy) / bh,
                        torch.log(gw / bw), torch.log(gh / bh)], dim=-1)


def decode_zf_deltas(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Deltas (dx, dy, dw, dh) onto anchors (x1, y1, x2, y2), +1 sizes: [..., 4]."""
    aw, ah, acx, acy = _center_form(anchors)
    cx = deltas[..., 0] * aw + acx
    cy = deltas[..., 1] * ah + acy
    pw = torch.exp(deltas[..., 2]) * aw
    ph = torch.exp(deltas[..., 3]) * ah
    return torch.stack([cx - pw / 2.0, cy - ph / 2.0, cx + pw / 2.0, cy + ph / 2.0], dim=-1)


def clip_to_image(boxes: torch.Tensor, image_shape) -> torch.Tensor:
    """Clip xyxy pixel boxes [..., 4] to [0, w − 1] × [0, h − 1]."""
    ih, iw = image_shape[:2]
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, iw - 1), y1.clamp(0, ih - 1),
                        x2.clamp(0, iw - 1), y2.clamp(0, ih - 1)], dim=-1)


class FasterRCNNRPN(nn.Module):
    """Single-level RPN head: NCHW map → logits [B, H, W, k, 2], foreground
    probabilities [B, H, W, k] (softmax over each anchor's pair) and deltas
    [B, H, W, k, 4]. The 1×1 heads compute in f32; their NCHW outputs are
    permuted to NHWC before the (k, 2) and (k, 4) reshapes."""

    def __init__(self, anchors_per_location: int = 9, dtype: torch.dtype = torch.float32,
                 cin: int = 512):
        super().__init__()
        k = anchors_per_location
        self.k = k
        self.dtype = dtype
        self.rpn_conv = Conv(cin, 512, 3)
        self.rpn_class = Conv(512, 2 * k, 1)
        self.rpn_bbox = Conv(512, 4 * k, 1)

    def forward(self, feature_map: torch.Tensor):
        x = F.relu(self.rpn_conv(feature_map.to(self.dtype))).to(torch.float32)
        scores = self.rpn_class(x).permute(0, 2, 3, 1)
        b, h, w, _ = scores.shape
        logits = scores.reshape(b, h, w, self.k, 2)
        probs = torch.softmax(logits, dim=-1)
        deltas = self.rpn_bbox(x).permute(0, 2, 3, 1).reshape(b, h, w, self.k, 4)
        return logits, probs[..., 1], deltas


def zf_proposal_layer(fg_probs: torch.Tensor, deltas: torch.Tensor, config: FasterRCNNConfig,
                      training: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """fg_probs [B, H, W, k], deltas [B, H, W, k, 4] → (proposals [B, P, 4]
    pixel xyxy zero-padded, valid [B, P]), P the post-NMS budget.

    Decode onto the ZF grid, clip to the image, mask boxes under
    ``min_box_size`` (+1 sizes) as -inf scores, keep the top pre-NMS budget
    (a stable sort: ties to the lower index), then NMS with the max corners
    shifted by +1 (the legacy +1 areas as continuous IoU) over the finite
    scores.
    """
    b, h, w, k = fg_probs.shape
    dev = fg_probs.device
    anchors = torch.from_numpy(zf_grid_anchors((h, w), config.backbone_stride)).to(dev)
    pre_nms = config.pre_nms_top_n_train if training else config.pre_nms_top_n_test
    post_nms = config.post_nms_top_n_train if training else config.post_nms_top_n_test
    pre_nms = min(pre_nms, anchors.shape[0])

    boxes = decode_zf_deltas(anchors[None], deltas.reshape(b, -1, 4))
    boxes = clip_to_image(boxes, config.image_shape)
    keep = ((boxes[..., 2] - boxes[..., 0] + 1 >= config.min_box_size)
            & (boxes[..., 3] - boxes[..., 1] + 1 >= config.min_box_size))
    scores = fg_probs.reshape(b, -1)
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top_scores, ix = top_k_stable(masked, pre_nms)
    top_boxes = torch.gather(boxes, 1, ix[..., None].expand(b, pre_nms, 4))
    shift = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=top_boxes.dtype, device=dev)
    res = non_max_suppression(top_boxes + shift, top_scores, post_nms, config.nms_threshold,
                              valid=torch.isfinite(top_scores))
    idx = res.indices.clamp(min=0)
    out = torch.gather(top_boxes, 1, idx[..., None].expand(*idx.shape, 4))
    return torch.where(res.valid[..., None], out, torch.zeros_like(out)), res.valid


def _dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """flax ``Dropout``: kept entries scaled by 1 / (1 − rate), the others 0."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class FastRCNNHead(nn.Module):
    """ROI pool + fc1/fc2 (1024, relu, dropout) + class and box outputs.

    feature_map [B, H, W, C] NHWC, rois [B, R, 4] pixel xyxy → (logits,
    probs [B, R, K], bbox [B, R, K, 4]). ``dropout``: the two keep masks
    [B, R, 1024] of a training step, or None (deterministic).
    """

    def __init__(self, num_classes: int, dropout_rate: float = DROPOUT_RATE,
                 dtype: torch.dtype = torch.float32, cin: int = 512):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        pooled = (HEAD_CROP // 2) ** 2 * cin
        self.fc1 = Dense(pooled, HIDDEN)
        self.fc2 = Dense(HIDDEN, HIDDEN)
        self.fc_class = Dense(HIDDEN, num_classes)
        self.fc_bbox = Dense(HIDDEN, 4 * num_classes)

    def forward(self, feature_map: torch.Tensor, rois: torch.Tensor, image_shape,
                dropout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        ih, iw = image_shape[:2]
        b, r = rois.shape[:2]
        c = feature_map.shape[-1]
        # xyxy pixels → yxyx normalized by the image size
        boxes = torch.stack([rois[..., 1] / ih, rois[..., 0] / iw,
                             rois[..., 3] / ih, rois[..., 2] / iw], dim=-1)
        crops = crop_and_resize(feature_map.to(self.dtype), boxes, (HEAD_CROP, HEAD_CROP))
        # 2×2/2 max pool; max_pool2d passes a window's gradient to its first
        # maximum, as XLA's select-and-scatter does
        nchw = crops.reshape(b * r, HEAD_CROP, HEAD_CROP, c).permute(0, 3, 1, 2)
        pooled = F.max_pool2d(nchw, 2, 2).permute(0, 2, 3, 1)
        x = pooled.reshape(b, r, -1)  # (ph, pw, C) order, as flax flattens
        keep1, keep2 = dropout if dropout is not None else (None, None)
        x = _dropout(F.relu(self.fc1(x)), keep1, self.dropout_rate)
        x = _dropout(F.relu(self.fc2(x)), keep2, self.dropout_rate)
        x = x.to(torch.float32)
        logits = self.fc_class(x)
        probs = torch.softmax(logits, dim=-1)
        bbox = self.fc_bbox(x).reshape(b, r, self.num_classes, 4)
        return logits, probs, bbox


class FasterRCNN(nn.Module):
    """VGG16 → RPN → proposals → Fast R-CNN head. Submodules are named as the
    flax scopes (``vgg16``, ``rpn``, ``fastrcnn``)."""

    def __init__(self, config: FasterRCNNConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.vgg16 = VGG16(dtype, cin=config.image_shape[2])
        self.rpn = FasterRCNNRPN(len(ZF_ANCHORS), dtype)
        self.fastrcnn = FastRCNNHead(config.num_classes, dtype=dtype)

    def features_and_rpn(self, images: torch.Tensor):
        """images [B, H, W, 3] → (feature map NHWC, rpn logits, fg probs, deltas)."""
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = self.vgg16(x)
        logits, fg_probs, deltas = self.rpn(feats)
        return feats.permute(0, 2, 3, 1), logits, fg_probs, deltas

    def classify(self, feats: torch.Tensor, rois: torch.Tensor,
                 dropout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """The head on explicit ROIs [B, R, 4]; ``dropout`` keep masks in training."""
        return self.fastrcnn(feats, rois, self.config.image_shape, dropout)

    def forward(self, images: torch.Tensor, training: bool = False) -> Dict[str, torch.Tensor]:
        feats, rpn_logits, fg_probs, deltas = self.features_and_rpn(images)
        proposals, valid = zf_proposal_layer(fg_probs, deltas, self.config, training=training)
        if training:  # proposals are inputs of the second stage
            proposals, valid = proposals.detach(), valid.detach()
        logits, probs, bbox = self.classify(feats, proposals)
        return {
            "feature_map": feats,
            "rpn_logits": rpn_logits,
            "fg_probs": fg_probs,
            "rpn_deltas": deltas,
            "proposals": proposals,
            "proposals_valid": valid,
            "class_logits": logits,
            "class_probs": probs,
            "bbox": bbox,
        }


@functools.lru_cache(maxsize=16)
def build_model(config: FasterRCNNConfig) -> FasterRCNN:
    """The module tree for ``config``, on the meta device (holds no weights)."""
    with torch.device("meta"):
        return FasterRCNN(config).eval()


def apply(params: Dict[str, torch.Tensor], images: torch.Tensor, config: FasterRCNNConfig,
          training: bool = False) -> Dict[str, torch.Tensor]:
    """The network's outputs for ``images`` [B, H, W, 3] with the state dict
    ``params`` (on the images' device)."""
    return functional_call(build_model(config), params, (images, training), strict=True)


class FasterRCNNDetections(NamedTuple):
    boxes: torch.Tensor  # [B, N, 4] pixel xyxy
    class_ids: torch.Tensor  # [B, N] int64, 0 for empty slots
    scores: torch.Tensor  # [B, N]
    valid: torch.Tensor  # [B, N] bool


def faster_rcnn_detections(outputs: Dict[str, torch.Tensor], config: FasterRCNNConfig,
                           score_threshold: float = 0.5, nms_threshold: float = 0.3,
                           max_detections: int = 50) -> FasterRCNNDetections:
    """Each proposal's best class, its box decoded and clipped, then
    class-aware NMS over the valid proposals of a foreground class above
    ``score_threshold``."""
    proposals, probs, bbox = outputs["proposals"], outputs["class_probs"], outputs["bbox"]
    b, r, _ = probs.shape
    cls = torch.argmax(probs, dim=-1)
    score = torch.gather(probs, 2, cls[..., None])[..., 0]
    delta = torch.gather(bbox, 2, cls[..., None, None].expand(b, r, 1, 4))[:, :, 0]
    boxes = clip_to_image(decode_zf_deltas(proposals, delta), config.image_shape)
    valid = outputs["proposals_valid"] & (cls > 0) & (score > score_threshold)
    res = non_max_suppression(boxes, score, max_detections, nms_threshold, valid=valid,
                              class_ids=cls.to(torch.int32))
    idx = res.indices.clamp(min=0)
    keep = res.valid
    out_boxes = torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4))
    return FasterRCNNDetections(
        boxes=torch.where(keep[..., None], out_boxes, torch.zeros_like(out_boxes)),
        class_ids=torch.where(keep, torch.gather(cls, 1, idx), torch.zeros_like(idx)),
        scores=torch.where(keep, torch.gather(score, 1, idx), 0.0),
        valid=keep,
    )


def make_infer_fn(config: FasterRCNNConfig, score_threshold: float = 0.5, device="cuda"):
    """Returns ``infer_fn(params, images) -> (outputs, FasterRCNNDetections)``
    on ``device``, the detections at ``faster_rcnn_detections``'s NMS
    defaults. ``images`` (numpy or a tensor) are moved there; ``params`` must
    already live there."""
    dev = resolve_device(device)

    def infer_fn(params, images):
        require_on(dev, params, "params")
        images = torch.as_tensor(images, dtype=torch.float32, device=dev)
        with torch.inference_mode():
            outputs = apply(params, images, config)
            return outputs, faster_rcnn_detections(outputs, config, score_threshold)

    return infer_fn
