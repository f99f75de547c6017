"""Detector configuration for the PyTorch port.

A field-for-field copy of ``objectdetection_tpu.config.DetectorConfig`` (same
names, same defaults), kept here so the port never imports the JAX package.
Configs are frozen dataclasses, specialized with :meth:`DetectorConfig.replace`.

Fields that only steer the TPU program's layout (``conv1_space_to_depth``,
``s2d_stage2``, ``int8_dot_lowering``, ``align_step_rois``,
``align_skip_chunks``, ``pallas_roi_align``, ``remat_backbone``,
``proposal_decode_all``) are read and ignored by the port: they do not change
the numbers. ``use_approx_topk`` is treated as exact top-k. The int8 fields
take effect with ``quantized_inference`` (the int8 serving path,
:mod:`objectdetection_torch.quant`), which serves but does not train
(:func:`objectdetection_torch.detector.check_supported`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DetectorConfig:
    """Mask R-CNN style detector configuration (COCO defaults)."""

    name: str = "coco"

    # --- image / preprocessing ---
    image_shape: Tuple[int, int, int] = (1024, 1024, 3)
    num_classes: int = 81
    image_min_dim: int = 800
    image_max_dim: int = 1024
    image_resize_mode: str = "square"
    image_min_scale: float = 0.0
    mean_pixel: Tuple[float, float, float] = (123.7, 116.8, 103.9)
    # multiplier applied to mean-subtracted inputs inside the model
    input_scale: float = 1.0

    # --- backbone ---
    backbone: str = "resnet101"
    batch_norm_decay: float = 0.9
    backbone_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    fpn_channels: int = 256

    # --- RPN / anchors ---
    rpn_anchor_stride: int = 1
    rpn_anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_anchor_scales: Tuple[float, ...] = (32, 64, 128, 256, 512)
    rpn_nms_threshold: float = 0.7
    rpn_bbox_stddev: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    bbox_stddev: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    pre_nms_rois_count: int = 6000
    post_nms_rois_training: int = 2000
    post_nms_rois_inference: int = 1000

    # --- detection head ---
    detection_min_threshold: float = 0.7
    detection_nms_threshold: float = 0.3
    detection_post_nms_instances: int = 100

    # --- ROI heads ---
    pool_shape: Tuple[int, int] = (7, 7)
    mask_pool_shape: Tuple[int, int] = (14, 14)
    mask_shape: Tuple[int, int] = (28, 28)

    # --- training ---
    rpn_train_anchors_per_image: int = 256
    train_rois_per_image: int = 200
    roi_positive_ratio: float = 0.33
    use_mini_mask: bool = True
    mini_mask_shape: Tuple[int, int] = (56, 56)
    max_gt_objects: int = 100

    # --- optimizer ---
    learning_rate: float = 0.001
    learning_rate_momentum: float = 0.9
    weight_decay: float = 1e-4
    gradient_clip_norm: float = 5.0
    lr_schedule: str = "constant"  # or "warmup_cosine"
    warmup_steps: int = 100
    total_train_steps: int = 10000

    # --- numerics / execution ---
    compute_dtype: str = "bfloat16"  # backbone/head conv compute dtype
    conv1_space_to_depth: bool = False  # TPU layout only: ignored
    remat_backbone: bool = False  # training memory option: ignored
    use_approx_topk: bool = True  # the port always selects exactly
    approx_topk_recall_target: float = 0.9
    quantized_inference: bool = False
    quantize_rpn: bool = True
    quantize_box_head: bool = True
    quantize_mask_head: bool = True
    quantize_fpn_p2: bool = True
    per_channel_acts: bool = False
    s2d_stage2: bool = False  # TPU layout only: ignored
    fused_bottleneck: bool = False
    pallas_roi_align: str = "all"  # TPU dispatch only: ignored
    int8_dot_lowering: bool = False  # TPU layout only: ignored
    proposal_decode_all: bool = True  # same numbers either way: ignored
    int8_pooled: bool = True
    int8_align_inputs: bool = True
    int8_stem: bool = False
    bf16_stages: Tuple[int, ...] = ()
    align_step_rois: int = 0  # TPU layout only: ignored
    align_skip_chunks: bool = True  # TPU layout only: ignored
    compat_reference_box_loss: bool = False
    train_append_gt: bool = False

    @property
    def num_anchors_per_location(self) -> int:
        return len(self.rpn_anchor_ratios)

    @property
    def fpn_levels(self) -> Tuple[int, ...]:
        """Pyramid levels carrying anchors (P2..P6)."""
        return tuple(range(2, 2 + len(self.backbone_strides)))

    @property
    def roi_levels(self) -> Tuple[int, ...]:
        """Pyramid levels used for ROIAlign (P2..P5)."""
        return (2, 3, 4, 5)

    def feature_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """Pyramid feature-map shapes for the configured image size."""
        h, w = self.image_shape[:2]
        return tuple((-(-h // s), -(-w // s)) for s in self.backbone_strides)

    def num_anchors(self) -> int:
        k = self.num_anchors_per_location
        return sum(fh * fw * k for fh, fw in self.feature_shapes())

    def replace(self, **kw) -> "DetectorConfig":
        return dataclasses.replace(self, **kw)

    def display(self) -> str:
        lines = ["Configurations:"]
        for f in dataclasses.fields(self):
            lines.append("{:35} {}".format(f.name, getattr(self, f.name)))
        return "\n".join(lines)


# Synthetic-shapes config (128² images, ResNet-50, 4 classes)
SHAPES_CONFIG = DetectorConfig(
    name="shapes",
    image_shape=(128, 128, 3),
    num_classes=4,  # background + square/circle/triangle
    image_min_dim=128,
    image_max_dim=128,
    backbone="resnet50",
    input_scale=1.0 / 64.0,  # trains from scratch (no pretrained backbone)
    rpn_anchor_scales=(8, 16, 32, 64, 128),
    train_rois_per_image=32,
    post_nms_rois_training=2000,
    post_nms_rois_inference=1000,
    use_mini_mask=False,
    mini_mask_shape=(0, 0),
    max_gt_objects=4,
)

COCO_CONFIG = DetectorConfig()
