"""Hybrid Task Cascade (HTC): three interleaved box and mask stages with mask
information flow and a semantic branch, on the Mask R-CNN backbone.

No JAX counterpart: Chen et al., "Hybrid Task Cascade for Instance
Segmentation" (arXiv:1901.07518), as mmdetection configures it
(``configs/htc/htc_r101_fpn_20e_coco.py``) and tests it
(``HybridTaskCascadeRoIHead.simple_test``), on a ``config.HTCConfig``:

- the backbone (``ResNetFPN``, P2..P6), the RPN head and the proposal layer
  are Mask R-CNN's modules, run as they are;
- :class:`SemanticHead` (mmdetection's ``FusedSemanticHead``): the semantic
  feature at the fusion level's stride (P3's, 8);
- three :class:`BoxHead` stages (``Shared2FCBBoxHead``, class-agnostic
  boxes): ROIAlign 7² over P2..P5 plus the semantic feature pooled at 14²
  and averaged to 7², two 1024-wide layers, class logits and box deltas
  decoded at the stage's stds; stages 1 and 2 refine the ROIs of the next;
- detection (:func:`layers.detection.per_class_detection_layer`): the
  stages' logits averaged, a softmax, every (ROI, class) pair above the
  score threshold through per-class NMS on B2, the best 100;
- three :class:`MaskHead` heads (``HTCMaskHead``) on the detections, each
  fed the previous head's trunk output through its ``conv_res``; the mask
  is the mean of their sigmoids at the detected class.

Float convs run :func:`backbone.float_conv` (on the card cuDNN, then the
E1 epilogue pass), every ROIAlign B1 (the semantic feature through its
single-map route). Tensors keep the Mask R-CNN family's layouts: images and
ROIAlign's maps NHWC, convs NCHW in channels_last memory, boxes normalized
``(y1, x1, y2, x2)``; class 0 is the background. Inference only: an
``HTCConfig`` does not train (:func:`detector.check_supported`).

Entry points: :func:`build_model` and :func:`make_infer_fn` (on the card
unless the caller asks for the CPU).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from objectdetection_torch import metrics
from objectdetection_torch.anchors import config_anchors
from objectdetection_torch.config import HTCConfig
from objectdetection_torch.convert import require_on, resolve_device
from objectdetection_torch.geometry import clip_boxes, decode_box_deltas, norm_boxes
from objectdetection_torch.layers.detection import per_class_detection_layer
from objectdetection_torch.layers.proposals import proposal_layer
from objectdetection_torch.models.backbone import (
    Conv, ResNetFPN, channels_last, float_conv, prelude,
)
from objectdetection_torch.models.heads import Dense
from objectdetection_torch.models.mask_rcnn import compute_dtype
from objectdetection_torch.models.rpn import RPNHead
from objectdetection_torch.ops import roi_align

MASK_CHANNELS = 256  # the mask heads' width
SEMANTIC_CONVS = 4  # the semantic head's 3×3 convs
SEMANTIC_CLASSES = 183  # COCO-stuff's classes: the semantic logits, training only


class SemanticHead(nn.Module):
    """P2..P6 NCHW → the semantic feature, NCHW at level ``fusion_level``'s
    size: every other level resized bilinearly to it (corners aligned), a
    1×1 conv + ReLU a level (``lateral``), summed; ``convs`` × (3×3 conv +
    ReLU), then a 1×1 ``embedding`` + ReLU, all ``channels`` wide.
    ``logits`` (the semantic classes) serves training only and is not run."""

    def __init__(self, levels: int, fusion_level: int, channels: int):
        super().__init__()
        self.fusion_level = fusion_level
        self.lateral = nn.ModuleList(Conv(channels, channels, 1) for _ in range(levels))
        self.convs = nn.ModuleList(Conv(channels, channels, 3) for _ in range(SEMANTIC_CONVS))
        self.embedding = Conv(channels, channels, 1)
        self.logits = Conv(channels, SEMANTIC_CLASSES, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        k = self.fusion_level
        size = tuple(feats[k].shape[-2:])
        x = float_conv(self.lateral[k], feats[k], relu=True)
        for i, f in enumerate(feats):
            if i != k:
                f = F.interpolate(f, size=size, mode="bilinear", align_corners=True)
                x = x + float_conv(self.lateral[i], channels_last(f), relu=True)
        for conv in self.convs:
            x = float_conv(conv, x, relu=True)
        return float_conv(self.embedding, x, relu=True)


class BoxHead(nn.Module):
    """Pooled ROIs [B, R, ph, pw, C] → (class logits [B, R, K], box deltas
    [B, R, 4]), both f32: flattened in (ph, pw, C) order, two ``channels``-wide
    layers + ReLU in the compute dtype, the outputs in f32."""

    def __init__(self, num_classes: int, pool_shape, cin: int, channels: int):
        super().__init__()
        ph, pw = pool_shape
        self.fc1 = Dense(ph * pw * cin, channels)
        self.fc2 = Dense(channels, channels)
        self.cls = Dense(channels, num_classes)
        self.reg = Dense(channels, 4)

    def forward(self, pooled: torch.Tensor, dtype: torch.dtype):
        b, r = pooled.shape[:2]
        x = F.relu(self.fc1(pooled.reshape(b, r, -1).to(dtype)))
        x = F.relu(self.fc2(x)).to(torch.float32)
        return self.cls(x), self.reg(x)


class MaskHead(nn.Module):
    """One stage's mask head on pooled ROIs NCHW [N, C, 14, 14]: with
    ``res`` it first adds ``conv_res`` (1×1 + ReLU) of the previous head's
    trunk output; 4 × (3×3 conv + ReLU) (the trunk), a 2×2 stride-2 deconv
    + ReLU, and the 1×1 class output at each ROI's class, in f32."""

    def __init__(self, num_classes: int, cin: int, channels: int, res: bool):
        super().__init__()
        if res:
            self.conv_res = Conv(channels, channels, 1)
        self.convs = nn.ModuleList(Conv(cin if i == 0 else channels, channels, 3)
                                   for i in range(4))
        # torch layout [in, out, kh, kw]
        self.deconv = nn.Module()
        self.deconv.weight = nn.Parameter(torch.zeros(channels, channels, 2, 2),
                                          requires_grad=False)
        self.deconv.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.logits = Conv(channels, num_classes, 1)

    def forward(self, x: torch.Tensor, last: Optional[torch.Tensor], class_ids: torch.Tensor):
        """(mask logits [N, 28, 28] f32 at ``class_ids`` [N], the trunk's
        output [N, C, 14, 14] for the next head)."""
        if last is not None:
            x = x + float_conv(self.conv_res, last, relu=True)
        for conv in self.convs:
            x = float_conv(conv, x, relu=True)
        d = self.deconv
        y = F.relu(F.conv_transpose2d(x, d.weight.to(x.dtype), d.bias.to(x.dtype), stride=2))
        y = y.to(torch.float32)
        kernel = self.logits.weight[:, :, 0, 0].to(y.dtype)  # [K, C]
        logits = torch.einsum("nchw,nc->nhw", y, kernel[class_ids])
        return logits + self.logits.bias[class_ids][:, None, None], x


class HTC(nn.Module):
    """images [B, H, W, 3] molded, windows [B, 4] pixels → (detections
    [B, N, 6] rows (y1, x1, y2, x2, class, score) zero-padded, masks
    [B, N, 28, 28]), N = ``detection_post_nms_instances``."""

    def __init__(self, config: HTCConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        c = cfg.fpn_channels
        self.fpn = ResNetFPN(cfg.backbone, c, cfg.image_shape[2])
        self.rpn_model = RPNHead(cfg.num_anchors_per_location, cfg.rpn_anchor_stride, c)
        self.semantic_head = SemanticHead(len(cfg.backbone_strides), cfg.semantic_fusion_level, c)
        self.box_heads = nn.ModuleList(BoxHead(cfg.num_classes, cfg.pool_shape, c,
                                               cfg.fc_channels) for _ in cfg.stage_stds)
        self.mask_heads = nn.ModuleList(MaskHead(cfg.num_classes, c, MASK_CHANNELS, res=t > 0)
                                        for t in range(cfg.num_stages))

    def pool(self, pyramid: Sequence[torch.Tensor], semantic: torch.Tensor, rois: torch.Tensor,
             crop) -> torch.Tensor:
        """ROIAlign ``crop`` over P2..P5 NHWC plus the semantic feature NHWC
        pooled at ``mask_pool_shape`` (averaged down to ``crop``):
        [B, R, ph, pw, C]."""
        cfg = self.config
        hw = tuple(cfg.image_shape[:2])
        x = roi_align.batched_multilevel_roi_align(pyramid, rois, hw, tuple(crop))
        s = roi_align.batched_multilevel_roi_align([semantic], rois, hw,
                                                   tuple(cfg.mask_pool_shape))
        b, r, sh, sw, c = s.shape
        ph, pw = crop
        if (sh, sw) != (ph, pw):
            s = s.reshape(b, r, ph, sh // ph, pw, sw // pw, c).mean(dim=(3, 5))
        return x + s

    def box_stages(self, pyramid, semantic, proposals: torch.Tensor,
                   window: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
        """(ROIs, class logits, box deltas, refined boxes) of each stage; the
        refined boxes, decoded at the stage's stds and clipped to ``window``
        [B, 1, 4], are the next stage's ROIs."""
        cfg = self.config
        dt = compute_dtype(cfg)
        rois, out = proposals, []
        for head, stds in zip(self.box_heads, cfg.stage_stds):
            logits, deltas = head(self.pool(pyramid, semantic, rois, cfg.pool_shape), dt)
            refined = clip_boxes(decode_box_deltas(rois, deltas, stds, cfg.max_log_size_delta),
                                 window)
            out.append((rois, logits, deltas, refined))
            rois = refined
        return out

    def mask_stages(self, pyramid, semantic, det: torch.Tensor, trunks: Optional[list] = None):
        """Soft masks [B, N, 28, 28] of detection rows [B, N, 6] (their boxes
        and classes): the mean of the heads' sigmoids; each head's trunk
        output appended to ``trunks`` where given."""
        cfg = self.config
        b, n = det.shape[:2]
        x = self.pool(pyramid, semantic, det[..., :4].contiguous(), cfg.mask_pool_shape)
        x = channels_last(x.reshape(b * n, *x.shape[2:]).permute(0, 3, 1, 2)
                          .to(compute_dtype(cfg)))
        ids = det[..., 4].reshape(-1).to(torch.int64)
        probs = last = None
        for head in self.mask_heads:
            logits, last = head(x, last, ids)
            if trunks is not None:
                trunks.append(last)
            p = torch.sigmoid(logits)
            probs = p if probs is None else probs + p
        probs = probs / len(self.mask_heads)
        return probs.reshape(b, n, *probs.shape[1:])

    def forward(self, images: torch.Tensor, windows: torch.Tensor,
                return_intermediates: bool = False):
        """(detections, masks), plus a dict of stage outputs with
        ``return_intermediates``: ``proposals``, ``semantic`` (NHWC),
        ``stages`` (:meth:`box_stages`), ``trunks`` (each mask head's
        trunk output)."""
        cfg = self.config
        with metrics.span("odtorch.backbone"):
            feats = self.fpn(prelude(images, cfg.input_scale, compute_dtype(cfg)))
        with metrics.span("odtorch.rpn"):
            _, rpn_probs, rpn_deltas = self.rpn_model(feats)
        with metrics.span("odtorch.proposals"):
            anchors = torch.from_numpy(config_anchors(cfg)).to(images.device)
            proposals = proposal_layer(rpn_probs, rpn_deltas, anchors, cfg)
        with metrics.span("odtorch.htc_semantic"):
            semantic = self.semantic_head(feats).permute(0, 2, 3, 1)
        pyramid = [f.permute(0, 2, 3, 1) for f in feats[:4]]
        window = norm_boxes(windows, cfg.image_shape[:2])[:, None, :]
        with metrics.span("odtorch.htc_box_stages"):
            stages = self.box_stages(pyramid, semantic, proposals, window)
        with metrics.span("odtorch.htc_detection"):
            logits = sum(s[1] for s in stages) / len(stages)
            det = per_class_detection_layer(stages[-1][3], torch.softmax(logits, dim=-1),
                                            (proposals != 0).any(-1), cfg.score_threshold, cfg)
        trunks = [] if return_intermediates else None
        with metrics.span("odtorch.htc_mask_stages"):
            masks = self.mask_stages(pyramid, semantic, det, trunks)
        if not return_intermediates:
            return det, masks
        return det, masks, {"proposals": proposals, "semantic": semantic, "stages": stages,
                            "trunks": trunks}


@functools.lru_cache(maxsize=16)
def build_model(config: HTCConfig) -> HTC:
    """The module tree for ``config``, on the meta device (holds no weights)."""
    if not isinstance(config, HTCConfig):
        raise TypeError(f"models.htc takes an HTCConfig, not {type(config).__name__}")
    with torch.device("meta"):
        return HTC(config).eval()


def apply(params: Dict[str, torch.Tensor], images: torch.Tensor, windows: torch.Tensor,
          config: HTCConfig, return_intermediates: bool = False):
    """:meth:`HTC.forward` with the state dict ``params``."""
    return functional_call(build_model(config), params,
                           (images, windows, return_intermediates), strict=True)


def make_infer_fn(config: HTCConfig, device="cuda"):
    """Returns ``infer_fn(params, images, windows) -> (detections [B, N, 6],
    masks [B, N, 28, 28])`` on ``device``. ``images`` (molded, [B, H, W, 3])
    and ``windows`` (pixels, [B, 4]) are moved there; ``params`` must live
    there."""
    build_model(config)
    dev = resolve_device(device)

    def infer_fn(params, images, windows):
        with metrics.span("odtorch.infer"):
            require_on(dev, params, "params")
            images = torch.as_tensor(images, dtype=torch.float32, device=dev)
            windows = torch.as_tensor(windows, dtype=torch.float32, device=dev)
            with torch.inference_mode():
                return apply(params, images, windows, config)

    return infer_fn
