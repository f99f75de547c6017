"""Detector configuration for the PyTorch port.

A field-for-field copy of ``objectdetection_tpu.config.DetectorConfig`` (same
names, same defaults), kept here so the port never imports the JAX package.
Configs are frozen dataclasses, specialized with :meth:`DetectorConfig.replace`.

Fields that only steer the TPU program's layout (``conv1_space_to_depth``,
``s2d_stage2``, ``int8_dot_lowering``, ``align_step_rois``,
``align_skip_chunks``, ``pallas_roi_align``, ``proposal_decode_all``) are
read and ignored by the port: they do not change the numbers.
``remat_backbone`` recomputes the Mask R-CNN backbone's blocks in the
backward pass (training memory against compute; the numbers do not
change). ``use_approx_topk`` is treated as exact top-k. The int8 fields
take effect with ``quantized_inference`` (the int8 serving path,
:mod:`objectdetection_torch.quant`), which serves but does not train
(:func:`objectdetection_torch.detector.check_supported`).

:class:`FasterRCNNConfig` is a field-for-field copy of the JAX package's
Faster R-CNN (VGG16) configuration. It has no ``lr_schedule``: the family
trains at a constant rate (:func:`objectdetection_torch.optim.update` with
``constant_lr=True``).

:class:`RetinaNetConfig` has no JAX counterpart: RetinaNet as its paper
publishes it (P3..P7, 9 anchors a location, the per-level decode): a
``DetectorConfig`` with three fields more (``anchor_octaves``,
``score_threshold``, ``pre_nms_per_level``) and the paper's defaults.
``DetectorConfig`` itself keeps the JAX package's fields and defaults, and
with them its RetinaNet.

:class:`HTCConfig` has no JAX counterpart either: Hybrid Task Cascade as
published (three interleaved box and mask stages, the semantic branch,
per-class detection), served by :mod:`objectdetection_torch.models.htc` on
the Mask R-CNN backbone, RPN and proposal layer.
"""

from __future__ import annotations

import dataclasses
import math
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
    remat_backbone: bool = False  # recompute the backbone's blocks in the backward
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

    # Not a field (the JAX package's field set stays whole): the sizes of one
    # level's anchors are its scale times each octave, one here;
    # RetinaNetConfig makes it a field.
    anchor_octaves = (1.0,)

    @property
    def num_anchors_per_location(self) -> int:
        return len(self.anchor_octaves) * len(self.rpn_anchor_ratios)

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


@dataclass(frozen=True)
class RetinaNetConfig(DetectorConfig):
    """RetinaNet as published (Lin et al., Focal Loss for Dense Object
    Detection, arXiv:1708.02002, §4 and its "Inference" paragraph; Detectron's
    ``retinanet_R-101-FPN``), where a ``DetectorConfig`` gives the JAX
    package's RetinaNet (P2..P6, ``len(rpn_anchor_ratios)`` anchors, the best
    class of each anchor before one global top-k).

    - Pyramid P3..P7 (``fpn_levels``, strides 8..128): P3..P5 from the FPN's
      C3..C5 laterals and 3×3 outputs, P6 a 3×3 stride-2 conv on C5, P7 ReLU
      then a 3×3 stride-2 conv on P6; no P2.
    - Anchors: ``rpn_anchor_scales`` (32..512) one a level, times each of
      ``anchor_octaves`` (2^0, 2^(1/3), 2^(2/3)), at each of
      ``rpn_anchor_ratios``: 9 a location, in (ratio, octave) order with the
      ratio outer (``anchors.anchors_for_level``), as torchvision's
      ``AnchorGenerator`` orders them (Detectron puts the octave outer).
    - Inference: every (anchor, class) sigmoid score above
      ``score_threshold``, at most ``pre_nms_per_level`` of them a level,
      decoded with ``rpn_bbox_stddev`` (Detectron's box weights, 1, 1, 1, 1)
      and clipped; the levels merged, then
      class-aware NMS at ``detection_nms_threshold`` to
      ``detection_post_nms_instances`` rows.
    """

    name: str = "retinanet"
    backbone_strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    rpn_anchor_scales: Tuple[float, ...] = (32, 64, 128, 256, 512)
    anchor_octaves: Tuple[float, ...] = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
    rpn_bbox_stddev: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    score_threshold: float = 0.05
    pre_nms_per_level: int = 1000
    detection_nms_threshold: float = 0.5
    detection_post_nms_instances: int = 100

    def __post_init__(self):
        want = tuple(2 ** level for level in self.fpn_levels)
        if tuple(self.backbone_strides) != want:
            raise ValueError(f"RetinaNetConfig: backbone_strides {self.backbone_strides} "
                             f"are not those of P3..P7, {want}")

    @property
    def fpn_levels(self) -> Tuple[int, ...]:
        """Pyramid levels carrying anchors (P3..P7)."""
        return tuple(range(3, 3 + len(self.backbone_strides)))


@dataclass(frozen=True)
class HTCConfig(DetectorConfig):
    """Hybrid Task Cascade (Chen et al., arXiv:1901.07518; mmdetection's
    ``configs/htc/htc_r101_fpn_20e_coco.py`` and its test path,
    ``HybridTaskCascadeRoIHead.simple_test``) on the Mask R-CNN backbone,
    RPN and proposal layer of a ``DetectorConfig``:

    - a semantic branch on P2..P6: each level resized bilinearly (corners
      aligned) to the size of level ``semantic_fusion_level`` (1: P3), a
      1×1 conv + ReLU a level, summed, then 4 × (3×3 conv + ReLU) and a 1×1
      embedding + ReLU, all ``fpn_channels`` wide; its 183-wide logits feed
      only the training loss;
    - ``len(stage_stds)`` box stages, each ROIAlign ``pool_shape`` over
      P2..P5 plus the semantic feature pooled at ``mask_pool_shape`` and
      average-pooled to ``pool_shape``, two ``fc_channels``-wide layers +
      ReLU, a class output and a class-agnostic box output decoded at the
      stage's ``stage_stds`` (the log-size delta clamped at
      ``max_log_size_delta``, boxes clipped to the window); each stage but
      the last refines the ROIs of the next;
    - detection: the stages' class logits averaged, a softmax, every
      (ROI, class) pair above ``score_threshold`` through per-class NMS at
      ``detection_nms_threshold``, the best ``detection_post_nms_instances``;
    - one mask head a stage on the detections (ROIAlign ``mask_pool_shape``
      plus the semantic feature pooled there), 4 × (3×3 conv 256 + ReLU), a
      2×2 stride-2 deconv + ReLU, a 1×1 class output; head t > 0 first adds
      a 1×1 conv + ReLU of head t − 1's trunk output; the mask is the mean
      of the heads' sigmoids at the detected class.

    Inference only (:func:`objectdetection_torch.detector.check_supported`).
    """

    name: str = "htc"
    stage_stds: Tuple[Tuple[float, float, float, float], ...] = (
        (0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1), (0.033, 0.033, 0.067, 0.067))
    max_log_size_delta: float = abs(math.log(16 / 1000))
    fc_channels: int = 1024
    semantic_fusion_level: int = 1
    score_threshold: float = 0.001
    detection_nms_threshold: float = 0.5
    detection_post_nms_instances: int = 100

    @property
    def num_stages(self) -> int:
        return len(self.stage_stds)


@dataclass(frozen=True)
class FasterRCNNConfig:
    """Faster R-CNN (VGG16, ZF anchors) configuration."""

    num_classes: int = 4
    image_shape: Tuple[int, int, int] = (224, 224, 3)
    backbone_stride: int = 16
    anchor_scales: Tuple[float, ...] = (8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)

    # train / test proposal budgets
    pre_nms_top_n_train: int = 12000
    post_nms_top_n_train: int = 2000
    pre_nms_top_n_test: int = 6000
    post_nms_top_n_test: int = 300
    nms_threshold: float = 0.2
    min_box_size: float = 16.0

    pool_shape: Tuple[int, int] = (7, 7)  # unread: the head pools 14x14 to 7x7

    # training
    rpn_train_anchors_per_image: int = 256
    rpn_bbox_stddev: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    bbox_stddev: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    train_rois_per_image: int = 64
    roi_positive_ratio: float = 0.25
    mask_shape: Tuple[int, int] = (14, 14)  # unused (no mask head)
    learning_rate: float = 0.001
    learning_rate_momentum: float = 0.9
    weight_decay: float = 5e-4
    gradient_clip_norm: float = 10.0

    def replace(self, **kw) -> "FasterRCNNConfig":
        return dataclasses.replace(self, **kw)
