"""The Mask R-CNN network: backbone + RPN + ROI heads in one module tree.

Port of ``objectdetection_tpu.models.mask_rcnn.MaskRCNN`` (float path):
``extract``, ``classify_rois`` and ``predict_masks``. Submodule names follow
the flax tree (``fpn``, ``rpn_model``, ``mrcnn``, ``mrcnn_mask``).

Public tensors keep the JAX layouts: images and pyramid levels NHWC, boxes
normalized (y1, x1, y2, x2). The convs run in channels_last memory on every
device, so the NHWC pyramid views the ROIAlign kernel reads are contiguous.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from objectdetection_torch.anchors import config_anchors
from objectdetection_torch.config import DetectorConfig
from objectdetection_torch.geometry import norm_boxes
from objectdetection_torch.layers.detection import detection_layer
from objectdetection_torch.layers.proposals import proposal_layer
from objectdetection_torch.models.backbone import ResNetFPN
from objectdetection_torch.models.heads import BoxClassHead, MaskHead
from objectdetection_torch.models.rpn import RPNHead
from objectdetection_torch.ops import roi_align

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def compute_dtype(config: DetectorConfig) -> torch.dtype:
    try:
        return _DTYPES[config.compute_dtype]
    except KeyError:
        raise ValueError(f"unsupported compute_dtype {config.compute_dtype!r}") from None


class MaskRCNN(nn.Module):
    def __init__(self, config: DetectorConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        c = cfg.fpn_channels
        self.fpn = ResNetFPN(cfg.backbone, c, cfg.image_shape[2])
        self.rpn_model = RPNHead(cfg.num_anchors_per_location, cfg.rpn_anchor_stride, c)
        self.mrcnn = BoxClassHead(cfg.num_classes, cfg.pool_shape[0], c)
        self.mrcnn_mask = MaskHead(cfg.num_classes, c)
        if cfg.pool_shape[0] != cfg.pool_shape[1]:
            raise ValueError("pool_shape must be square")

    def extract(self, images: torch.Tensor):
        """images [B, H, W, 3] → (P2..P6 NHWC, rpn logits, probs, deltas)."""
        cfg = self.config
        dt = compute_dtype(cfg)
        if cfg.input_scale != 1.0:
            images = images * cfg.input_scale
        x = images.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=torch.channels_last)
        feats = self.fpn(x)
        logits, probs, deltas = self.rpn_model(feats)
        return [f.permute(0, 2, 3, 1) for f in feats], logits, probs, deltas

    def _roi_align(self, feats: Sequence[torch.Tensor], rois, crop_size):
        return roi_align.batched_multilevel_roi_align(
            list(feats[:4]), rois, tuple(self.config.image_shape[:2]), tuple(crop_size)
        )

    def classify_rois(self, feats: Sequence[torch.Tensor], rois: torch.Tensor):
        """ROIAlign 7² + box/class head: rois [B, R, 4] → (logits, probs, bbox)."""
        pooled = self._roi_align(feats, rois, self.config.pool_shape)
        return self.mrcnn(pooled, compute_dtype(self.config))

    def predict_masks(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                      class_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ROIAlign 14² + mask head: [B, R, 28, 28] for each ROI's class
        (or [B, R, 28, 28, K] without ``class_ids``)."""
        pooled = self._roi_align(feats, rois, self.config.mask_pool_shape)
        return self.mrcnn_mask(pooled, class_ids, compute_dtype(self.config))

    def forward(self, images: torch.Tensor, windows: torch.Tensor,
                with_masks: bool = True, return_intermediates: bool = False):
        """The inference pipeline on molded images: returns (detections
        [B, N, 6], masks [B, N, 28, 28] or None, intermediates dict or None)."""
        cfg = self.config
        dt = compute_dtype(cfg)
        feats, rpn_logits, rpn_probs, rpn_deltas = self.extract(images)
        anchors = torch.from_numpy(config_anchors(cfg)).to(images.device)
        proposals = proposal_layer(rpn_probs, rpn_deltas, anchors, cfg)
        roi_pooled = self._roi_align(feats, proposals, cfg.pool_shape)
        _, cls_probs, bbox = self.mrcnn(roi_pooled, dt)
        norm_windows = norm_boxes(windows, cfg.image_shape[:2])
        det = detection_layer(proposals, cls_probs, bbox, norm_windows, cfg)
        masks = mask_pooled = None
        if with_masks:
            mask_pooled = self._roi_align(feats, det[..., :4], cfg.mask_pool_shape)
            masks = self.mrcnn_mask(mask_pooled, det[..., 4].to(torch.int64), dt)
        intermediates = None
        if return_intermediates:
            # the JAX package's keys, plus the two ROIAlign outputs
            intermediates = {
                "pyramid": {f"p{i + 2}": f for i, f in enumerate(feats)},
                "rpn_class_logits": rpn_logits,
                "rpn_class_probs": rpn_probs,
                "rpn_bbox": rpn_deltas,
                "proposals": proposals,
                "roi_pooled": roi_pooled,
                "mrcnn_class_probs": cls_probs,
                "mrcnn_bbox": bbox,
                "detections": det,
                "mask_pooled": mask_pooled,
            }
        return det, masks, intermediates
