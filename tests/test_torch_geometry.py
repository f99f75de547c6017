"""Config, anchors and box geometry of the port against the JAX package.

Config fields and anchors are held exactly (the port keeps its own copies).
Geometry runs op for op in f32: equal except where the two frameworks' ``exp``
and ``log`` differ in the last bit, hence rtol 1e-6 where those appear.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu import anchors as janchors
from objectdetection_tpu import config as jconfig
from objectdetection_tpu import geometry as jgeo

from objectdetection_torch import anchors as tanchors
from objectdetection_torch import config as tconfig
from objectdetection_torch import geometry as tgeo

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["COCO_CONFIG", "SHAPES_CONFIG"])
def test_config_copy_has_every_field_and_default(name):
    jc, tc = getattr(jconfig, name), getattr(tconfig, name)
    jfields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    tfields = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
    assert tfields == jfields
    assert tc.feature_shapes() == jc.feature_shapes()
    assert tc.num_anchors() == jc.num_anchors()
    assert tc.fpn_levels == jc.fpn_levels and tc.roi_levels == jc.roi_levels


@pytest.mark.parametrize("name", ["COCO_CONFIG", "SHAPES_CONFIG"])
def test_anchors_identical(name):
    jc, tc = getattr(jconfig, name), getattr(tconfig, name)
    for normalized in (True, False):
        np.testing.assert_array_equal(
            tanchors.config_anchors(tc, normalized), janchors.config_anchors(jc, normalized))
    assert tanchors.anchors_per_level_counts(tc) == janchors.anchors_per_level_counts(jc)


def boxes(rng, n):
    """Random, zero-area and inverted boxes in [0, 1]."""
    b = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    b[: n // 4, 2] = b[: n // 4, 0]  # zero height
    b[n // 4: n // 2] = 0.0  # all-zero rows
    return b  # the rest mixes proper and inverted corners


def test_norm_denorm_match():
    rng = np.random.RandomState(0)
    pix = rng.uniform(0, 1024, (2, 50, 4)).astype(np.float32)
    shape = (1024, 800)
    np.testing.assert_array_equal(
        tgeo.norm_boxes(torch.from_numpy(pix), shape).numpy(),
        np.asarray(jgeo.norm_boxes(jnp.asarray(pix), shape)))
    norm = np.array(jgeo.norm_boxes(jnp.asarray(pix), shape))
    for rnd in (True, False):
        np.testing.assert_array_equal(
            tgeo.denorm_boxes(torch.from_numpy(norm), shape, round=rnd).numpy(),
            np.asarray(jgeo.denorm_boxes(jnp.asarray(norm), shape, round=rnd)))


def test_deltas_clip_iou_match():
    rng = np.random.RandomState(1)
    a, b = boxes(rng, 64), boxes(rng, 48)
    d = rng.normal(0, 0.5, (64, 4)).astype(np.float32)
    win = np.array([0.1, 0.05, 0.9, 0.95], np.float32)
    ta, tb, td = (torch.from_numpy(x) for x in (a, b, d))
    np.testing.assert_allclose(tgeo.apply_box_deltas(ta, td).numpy(),
                               np.asarray(jgeo.apply_box_deltas(jnp.asarray(a), jnp.asarray(d))),
                               rtol=1e-6, atol=1e-7)
    gt = a[::-1].copy() + 0.5  # positive extents for the log
    pos = a + np.array([0, 0, 1, 1], np.float32)
    np.testing.assert_allclose(
        tgeo.encode_box_deltas(torch.from_numpy(pos), torch.from_numpy(gt)).numpy(),
        np.asarray(jgeo.encode_box_deltas(jnp.asarray(pos), jnp.asarray(gt))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tgeo.clip_boxes(ta, win).numpy(),
                                  np.asarray(jgeo.clip_boxes(jnp.asarray(a), win)))
    np.testing.assert_array_equal(tgeo.box_area(ta).numpy(),
                                  np.asarray(jgeo.box_area(jnp.asarray(a))))
    np.testing.assert_array_equal(tgeo.iou_matrix(ta, tb).numpy(),
                                  np.asarray(jgeo.iou_matrix(jnp.asarray(a), jnp.asarray(b))))
