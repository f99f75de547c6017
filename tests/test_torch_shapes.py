"""The port's shapes dataset and rasterizer against the JAX package's.

- ``image_meta`` (the specs drawn by ``default_rng(seed)``) equals JAX's for
  several seeds and canvas sizes.
- ``load_batch`` is bit-equal to JAX's ``load_batch(use_native=True)`` (the
  C++ rasterizer, built by the JAX package's own loader into this test's
  temporary directory) at 128² and 64², with and without masks, and on
  random specs of every shape at other sizes; a difference fails with the
  count and the positions of the differing elements. The port follows the
  library as g++ builds it with ``-O3 -march=native`` on a CPU with FMA,
  which contracts the triangle's apex arithmetic (see ``shapes_raster``);
  the fixture rasterizes one triangle that plain f32 decides otherwise, and
  a failure names the build when the library did not contract.
- Against JAX's ``cv2`` path (``use_native=False``), which the native one
  matches only approximately (tests/test_native.py), every instance's mask
  IoU is above 0.93 and the class ids are equal; the port's ``image`` and
  ``masks`` are the batch's pixels and masks.
"""

import numpy as np
import pytest
import torch

from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES
from objectdetection_tpu.data.shapes import ShapesDataset as JShapes

from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.data import shapes_raster
from objectdetection_torch.data.shapes import CLASS_NAMES, ShapesDataset

torch.set_num_threads(1)

FIELDS = ("images", "gt_boxes", "gt_class_ids", "gt_masks", "active_class_ids")
# set by the ``native`` fixture when the built library rounds as plain f32
BUILD_NOTE = ""


def plain_f32_triangle(h, w, cy, cx, s):
    """The port's triangle with every product rounded to f32 on its own (no
    fused multiply-add)."""
    f32, inv = np.float32, shapes_raster.INV_SIN60
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shapes_raster, "_sign", lambda ax, ay, bx, by, cx, cy:
                   (ax - cx) * (by - cy) - (bx - cx) * (ay - cy))
        mp.setattr(shapes_raster, "_fused", lambda cx, s, sign:
                   f32(f32(cx) + f32(sign) * (f32(s) * inv)))
        return shapes_raster.raster_instance(h, w, 3, cy, cx, s)


def contraction_note(loader):
    """"" when the library rasterizes a triangle whose apex fused and plain
    f32 decide differently as the port does; else what it did."""
    h = w = 64
    for s in range(2, 30):
        for cy, cx in ((32, 32), (31, 17), (40, 45)):
            fused = shapes_raster.raster_instance(h, w, 3, cy, cx, s)
            plain = plain_f32_triangle(h, w, cy, cx, s)
            if np.array_equal(fused, plain):
                continue
            specs = np.zeros((1, 1, 7), np.int32)
            specs[0, 0] = [3, cy, cx, s, 255, 255, 255]
            masks = loader.rasterize_shapes_batch(specs, np.zeros((1, 3), np.int32), h, w,
                                                  (0.0, 0.0, 0.0))[1][0, 0] > 0.5
            if np.array_equal(masks, fused):
                return ""
            which = "plain f32" if np.array_equal(masks, plain) else "neither"
            return (f" [the native library decides the triangle (cy {cy}, cx {cx}, s {s}) as "
                    f"{which}, not with the fused multiply-adds that g++ -O3 -march=native "
                    f"emits on a CPU with FMA: it was built with other flags (the loader's "
                    f"fallback drops -march=native) or on a CPU without FMA]")
    return ""


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """JAX's native rasterizer, built by its loader into a directory of this
    test (no other test process writes there)."""
    from objectdetection_tpu.native import loader

    saved = (loader._SO, loader._lib, loader._build_failed)
    loader._SO = str(tmp_path_factory.mktemp("native") / "libshapes_raster.so")
    loader._lib, loader._build_failed = None, False
    try:
        if not loader.native_available():
            pytest.fail("the JAX package's native rasterizer did not build (g++ with OpenMP)")
        global BUILD_NOTE
        BUILD_NOTE = contraction_note(loader)
        yield loader
    finally:
        loader._SO, loader._lib, loader._build_failed = saved


def configs(size):
    over = dict(image_shape=(size, size, 3), image_min_dim=size, image_max_dim=size)
    return J_SHAPES.replace(**over), T_SHAPES.replace(**over)


def assert_bit_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape)
    diff = np.argwhere(got != want)
    assert not len(diff), (f"{what}: {len(diff)} elements differ, first at "
                           f"{diff[:10].tolist()}{BUILD_NOTE}")


@pytest.mark.parametrize("size", [128, 64, 96])
@pytest.mark.parametrize("seed", [0, 3, 21])
def test_image_meta_equals_jax(seed, size):
    assert ShapesDataset(12, size, size, seed=seed).image_meta == \
        JShapes(12, size, size, seed=seed).image_meta


@pytest.mark.parametrize("with_masks", [True, False])
@pytest.mark.parametrize("size", [128, 64])
def test_load_batch_bit_equal_to_the_native_rasterizer(native, size, with_masks):
    jcfg, tcfg = configs(size)
    for seed in range(12):
        ids = list(range(8))
        want = JShapes(8, size, size, seed=seed).load_batch(ids, jcfg, with_masks,
                                                             use_native=True)
        got = ShapesDataset(8, size, size, seed=seed).load_batch(ids, tcfg, with_masks)
        for f in FIELDS:
            if getattr(want, f) is None:
                assert getattr(got, f) is None
                continue
            assert_bit_equal(getattr(got, f), getattr(want, f), f"seed {seed} {f}")


@pytest.mark.parametrize("h,w", [(128, 128), (100, 90), (256, 64)])
def test_random_specs_bit_equal_to_the_native_rasterizer(native, h, w):
    # every shape, sizes from 0 to half the canvas, centres anywhere on it,
    # up to 5 overlapping instances (occlusion, dropped empty instances)
    rng = np.random.RandomState(h + w)
    specs = np.zeros((16, 5, 7), np.int32)
    for i in range(16):
        for j in range(rng.randint(1, 6)):
            specs[i, j] = [rng.randint(1, 4), rng.randint(0, h), rng.randint(0, w),
                           rng.randint(0, h // 2), *rng.randint(0, 256, 3)]
    bg = rng.randint(0, 256, (16, 3)).astype(np.int32)
    mean = (123.7, 116.8, 103.9)
    want = native.rasterize_shapes_batch(specs, bg, h, w, mean)
    got = shapes_raster.rasterize_shapes_batch(specs, bg, h, w, mean)
    for name, g, wv in zip(("images", "masks", "boxes", "classes"), got, want):
        assert_bit_equal(g, wv, name)


def test_masks_agree_with_the_cv2_path():
    pytest.importorskip("cv2")
    jcfg, tcfg = configs(128)
    ids = list(range(6))
    py = JShapes(6, 128, 128, seed=21).load_batch(ids, jcfg, True, use_native=False)
    ds = ShapesDataset(6, 128, 128, seed=21)
    got = ds.load_batch(ids, tcfg, True)
    for bi in range(6):
        np.testing.assert_array_equal(got.gt_class_ids[bi], py.gt_class_ids[bi])
        for j in np.where(py.gt_class_ids[bi] > 0)[0]:
            a, b = got.gt_masks[bi, j] > 0.5, py.gt_masks[bi, j] > 0.5
            assert (a & b).sum() / (a | b).sum() > 0.93, (bi, j)


def test_image_and_masks_are_the_batch():
    _, tcfg = configs(128)
    ds = ShapesDataset(6, 128, 128, seed=4)
    batch = ds.load_batch(list(range(6)), tcfg, True)
    mean = np.asarray(tcfg.mean_pixel, np.float32)
    for i in range(6):
        np.testing.assert_array_equal(ds.image(i).astype(np.float32) - mean, batch.images[i])
        masks, class_ids = ds.masks(i)
        assert masks.dtype == bool and masks.shape[:2] == (128, 128)
        assert class_ids.tolist() == [CLASS_NAMES.index(s[0])
                                      for s in ds.image_meta[i]["instances"]]
        boxes = ds.bboxes_from_masks(masks)
        visible = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        n = int(visible.sum())
        np.testing.assert_array_equal(batch.gt_class_ids[i, :n], class_ids[visible][:4])
        np.testing.assert_array_equal(batch.gt_masks[i, :n] > 0,
                                      np.transpose(masks[:, :, visible], (2, 0, 1))[:4])
        scale = np.array([127, 127, 127, 127], np.float32)
        np.testing.assert_allclose(batch.gt_boxes[i, :n] * scale + [0, 0, 1, 1],
                                   boxes[visible][:4], atol=1e-4)
