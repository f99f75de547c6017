"""FPN pyramid anchor generation (numpy).

A copy of ``objectdetection_tpu.anchors``: per level, a meshgrid of
(scale × ratio) boxes swept over feature-map positions, concatenated across
the config's pyramid levels (P2..P6, or P3..P7 for a ``RetinaNetConfig``) in
(level, y, x, anchor) order and normalized with the ``(h-1, w-1)``
convention. A level's sizes are its scale times each of the config's
``anchor_octaves`` (one, 1.0, but for RetinaNet's three), so the anchors of a
location run in (ratio, octave) order, the ratio outer. Anchors depend only
on the config, so they are computed once in numpy and cached.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

from objectdetection_torch.config import DetectorConfig


def anchors_for_level(
    scales,
    ratios: Sequence[float],
    feature_shape: Tuple[int, int],
    feature_stride: int,
    anchor_stride: int = 1,
) -> np.ndarray:
    """Anchor corner boxes for one pyramid level, in pixels, (y, x, anchor) order."""
    scales, ratios = np.meshgrid(np.array(scales), np.array(ratios))
    scales = scales.flatten()
    ratios = ratios.flatten()

    heights = scales / np.sqrt(ratios)
    widths = scales * np.sqrt(ratios)

    shifts_y = np.arange(0, feature_shape[0], anchor_stride) * feature_stride
    shifts_x = np.arange(0, feature_shape[1], anchor_stride) * feature_stride
    shifts_x, shifts_y = np.meshgrid(shifts_x, shifts_y)

    box_widths, box_centers_x = np.meshgrid(widths, shifts_x)
    box_heights, box_centers_y = np.meshgrid(heights, shifts_y)

    box_centers = np.stack([box_centers_y, box_centers_x], axis=2).reshape(-1, 2)
    box_sizes = np.stack([box_heights, box_widths], axis=2).reshape(-1, 2)

    return np.concatenate(
        [box_centers - 0.5 * box_sizes, box_centers + 0.5 * box_sizes], axis=1
    )


def _norm_boxes_np(boxes: np.ndarray, image_shape) -> np.ndarray:
    h, w = image_shape[0], image_shape[1]
    scale = np.array([h - 1, w - 1, h - 1, w - 1])
    shift = np.array([0, 0, 1, 1])
    return ((boxes - shift) / scale).astype(np.float32)


@functools.lru_cache(maxsize=16)
def pyramid_anchors_pixel(
    image_shape: Tuple[int, int],
    scales: Tuple[float, ...],
    ratios: Tuple[float, ...],
    strides: Tuple[int, ...],
    anchor_stride: int = 1,
    octaves: Tuple[float, ...] = (1.0,),
) -> np.ndarray:
    """All pyramid anchors in pixel coords, concatenated level after level:
    [A, 4]. A level's sizes are its scale times each of ``octaves``."""
    h, w = image_shape
    per_level = []
    for scale, stride in zip(scales, strides):
        fshape = (-(-h // stride), -(-w // stride))
        per_level.append(
            anchors_for_level([scale * o for o in octaves], ratios, fshape, stride,
                              anchor_stride)
        )
    return np.concatenate(per_level, axis=0)


def pyramid_anchors_normalized(
    image_shape: Tuple[int, int],
    scales: Tuple[float, ...],
    ratios: Tuple[float, ...],
    strides: Tuple[int, ...],
    anchor_stride: int = 1,
    octaves: Tuple[float, ...] = (1.0,),
) -> np.ndarray:
    """Normalized pyramid anchors [A, 4]."""
    pix = pyramid_anchors_pixel(image_shape, scales, ratios, strides, anchor_stride, octaves)
    return _norm_boxes_np(pix, image_shape)


def config_anchors(config: DetectorConfig, normalized: bool = True) -> np.ndarray:
    """Anchors for a config's image shape: [A, 4] float32."""
    fn = pyramid_anchors_normalized if normalized else pyramid_anchors_pixel
    return fn(
        tuple(config.image_shape[:2]),
        tuple(config.rpn_anchor_scales),
        tuple(config.rpn_anchor_ratios),
        tuple(config.backbone_strides),
        config.rpn_anchor_stride,
        tuple(config.anchor_octaves),
    )


def anchors_per_level_counts(config: DetectorConfig) -> Tuple[int, ...]:
    """Number of anchors contributed by each pyramid level."""
    k = config.num_anchors_per_location
    return tuple(fh * fw * k for fh, fw in config.feature_shapes())
