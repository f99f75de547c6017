"""The Mask R-CNN network: backbone + RPN + ROI heads in one module tree.

Port of ``objectdetection_tpu.models.mask_rcnn.MaskRCNN``: ``extract``,
``classify_rois`` and ``predict_masks``. Submodule names follow the flax tree
(``fpn``, ``rpn_model``, ``mrcnn``, ``mrcnn_mask``).

With ``quantized_inference`` the network is the int8 serving path
(:mod:`objectdetection_torch.quant`), and the model holds the pooled-ROI
scales ``pooled_box_scale`` ([ph·pw·C] per position with per-channel acts,
else one scalar) and ``pooled_mask_scale`` ([C] or scalar): calibration
records them on the pooled tensors, the same statistic as the heads' first
layers' ``act_scale``, and serving hands them to ROIAlign as an ``out_quant``
map so that it returns the heads' int8 inputs. With ``int8_align_inputs``
ROIAlign reads the int8 P2..P5 the RPN quantized instead of the float
pyramid. The port has one route for both, kernel or plain version: the JAX
package takes it only on the TPU (its CPU path pools in float and lets the
heads quantize, which gives the same codes for a float input).

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
from objectdetection_torch import metrics
from objectdetection_torch import quant as Q
from objectdetection_torch.models.backbone import Quant, ResNetFPN, prelude
from objectdetection_torch.models.heads import BoxClassHead, MaskHead
from objectdetection_torch.models.rpn import RPNHead
from objectdetection_torch.ops import roi_align

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def compute_dtype(config: DetectorConfig) -> torch.dtype:
    try:
        return _DTYPES[config.compute_dtype]
    except KeyError:
        raise ValueError(f"unsupported compute_dtype {config.compute_dtype!r}") from None


def quant_spec(config: DetectorConfig, enabled: bool = True) -> Optional[Quant]:
    """The int8 options of ``config`` for a part of the network, or None
    when that part runs float."""
    if not (config.quantized_inference and enabled):
        return None
    return Quant(dtype=compute_dtype(config), per_channel=config.per_channel_acts,
                 fused=config.fused_bottleneck, int8_stem=config.int8_stem,
                 bf16_stages=tuple(config.bf16_stages), quantize_p2=config.quantize_fpn_p2)


class MaskRCNN(nn.Module):
    def __init__(self, config: DetectorConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        c = cfg.fpn_channels
        self.fpn = ResNetFPN(cfg.backbone, c, cfg.image_shape[2], quant_spec(cfg),
                             remat=cfg.remat_backbone)
        self.rpn_model = RPNHead(cfg.num_anchors_per_location, cfg.rpn_anchor_stride, c,
                                 quant=quant_spec(cfg, cfg.quantize_rpn))
        self.mrcnn = BoxClassHead(cfg.num_classes, tuple(cfg.pool_shape), c,
                                  quant=quant_spec(cfg, cfg.quantize_box_head))
        # the mask head is 256 wide whatever the FPN's width, as in the flax model
        self.mrcnn_mask = MaskHead(cfg.num_classes, 256, cin=c,
                                   quant=quant_spec(cfg, cfg.quantize_mask_head))
        if cfg.quantized_inference:
            ph, pw = cfg.pool_shape
            pc = cfg.per_channel_acts
            self.register_buffer("pooled_box_scale",
                                 torch.zeros(ph * pw * c) if pc else torch.zeros(()))
            self.register_buffer("pooled_mask_scale", torch.zeros(c) if pc else torch.zeros(()))

    def extract(self, images: torch.Tensor, return_qfeats: bool = False):
        """images [B, H, W, 3] → (P2..P6 NHWC, rpn logits, probs, deltas), plus
        ``(int8 P2..P5 NHWC, scale)`` or None with ``return_qfeats``."""
        cfg = self.config
        dt = compute_dtype(cfg)
        with metrics.span("odtorch.backbone"):
            feats = self.fpn(prelude(images, cfg.input_scale, dt))
            feats_nhwc = [f.permute(0, 2, 3, 1) for f in feats]
        with metrics.span("odtorch.rpn"):
            if return_qfeats:
                logits, probs, deltas, q = self.rpn_model(feats, return_quantized_inputs=True)
                if q is not None:
                    q = (q[0][:4], q[1])  # ROIAlign reads P2..P5
                return feats_nhwc, logits, probs, deltas, q
            logits, probs, deltas = self.rpn_model(feats)
        return feats_nhwc, logits, probs, deltas

    def _roi_align(self, feats: Sequence[torch.Tensor], rois, crop_size,
                   out_quant=None, qfeats=None):
        feats, in_scale = list(feats[:4]), None
        if qfeats is not None and self.config.int8_align_inputs:
            feats, in_scale = list(qfeats[0][:4]), qfeats[1]
        return roi_align.batched_multilevel_roi_align(
            feats, rois, tuple(self.config.image_shape[:2]), tuple(crop_size),
            out_quant=out_quant, in_scale=in_scale)

    def _int8_pooled(self, head_quantized: bool) -> bool:
        cfg = self.config
        return (cfg.quantized_inference and head_quantized and cfg.int8_pooled
                and not Q.calibrating())

    def classify_rois(self, feats: Sequence[torch.Tensor], rois: torch.Tensor, qfeats=None):
        """ROIAlign 7² + box/class head: rois [B, R, 4] → (logits, probs, bbox)."""
        return self._classify(feats, rois, qfeats)[1]

    def predict_masks(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                      class_ids: Optional[torch.Tensor] = None, qfeats=None) -> torch.Tensor:
        """ROIAlign 14² + mask head: [B, R, 28, 28] for each ROI's class
        (or [B, R, 28, 28, K] without ``class_ids``)."""
        return self._masks(feats, rois, class_ids, qfeats)[1]

    def _classify(self, feats, rois, qfeats):
        """(pooled ROIs, (logits, probs, bbox))."""
        cfg = self.config
        ph, pw = cfg.pool_shape
        c = cfg.fpn_channels
        out_quant = None
        if self._int8_pooled(cfg.quantize_box_head):
            out_quant = self.pooled_box_scale.expand(ph * pw * c).reshape(ph, pw, c)
        pooled = self._roi_align(feats, rois, cfg.pool_shape, out_quant, qfeats)
        if cfg.quantized_inference and Q.calibrating():
            Q._record(self.pooled_box_scale, pooled.reshape(-1, ph * pw * c), -1)
        dt = compute_dtype(cfg)
        if pooled.dtype == torch.int8:
            return pooled, self.mrcnn(pooled, dt, in_scale=self.pooled_box_scale)
        return pooled, self.mrcnn(pooled, dt)

    def _masks(self, feats, rois, class_ids, qfeats):
        """(pooled ROIs, masks)."""
        cfg = self.config
        mh, mw = cfg.mask_pool_shape
        c = cfg.fpn_channels
        out_quant = None
        if self._int8_pooled(cfg.quantize_mask_head):
            out_quant = self.pooled_mask_scale.expand(c).expand(mh, mw, c)
        pooled = self._roi_align(feats, rois, cfg.mask_pool_shape, out_quant, qfeats)
        if cfg.quantized_inference and Q.calibrating():
            Q._record(self.pooled_mask_scale, pooled, -1)
        dt = compute_dtype(cfg)
        if pooled.dtype == torch.int8:
            return pooled, self.mrcnn_mask(pooled, class_ids, dt,
                                           in_scale=self.pooled_mask_scale)
        return pooled, self.mrcnn_mask(pooled, class_ids, dt)

    def forward(self, images: torch.Tensor, windows: torch.Tensor,
                with_masks: bool = True, return_intermediates: bool = False):
        """The inference pipeline on molded images: returns (detections
        [B, N, 6], masks [B, N, 28, 28] or None, intermediates dict or None)."""
        cfg = self.config
        want_q = cfg.quantized_inference and cfg.quantize_rpn and cfg.int8_align_inputs
        if want_q:
            feats, rpn_logits, rpn_probs, rpn_deltas, qfeats = self.extract(images, True)
        else:
            feats, rpn_logits, rpn_probs, rpn_deltas = self.extract(images)
            qfeats = None
        with metrics.span("odtorch.proposals"):
            anchors = torch.from_numpy(config_anchors(cfg)).to(images.device)
            proposals = proposal_layer(rpn_probs, rpn_deltas, anchors, cfg)
        with metrics.span("odtorch.box_stage"):
            roi_pooled, (_, cls_probs, bbox) = self._classify(feats, proposals, qfeats)
        with metrics.span("odtorch.detection"):
            norm_windows = norm_boxes(windows, cfg.image_shape[:2])
            det = detection_layer(proposals, cls_probs, bbox, norm_windows, cfg)
        masks = mask_pooled = None
        if with_masks:
            with metrics.span("odtorch.mask_stage"):
                if metrics.collecting():
                    # every detection row runs the mask stage, empty or not
                    metrics.count("mask_stage.rows", det.shape[0] * det.shape[1])
                    metrics.count("mask_stage.valid", (det[..., 5] > 0).sum())
                mask_pooled, masks = self._masks(feats, det[..., :4],
                                                 det[..., 4].to(torch.int64), qfeats)
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
