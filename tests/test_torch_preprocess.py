"""The port's molding and unmolding against the JAX package's.

Same seeded numpy inputs through both. Tolerances:

- resize parameters, windows and scales: equal (scale within 1e-6, f32);
- host mold against JAX's ``cv2`` mold: within 1e-3 on the 0-255 scale, for
  an upscale, a downscale, an exact 2× downscale, the no-resize case and
  ``image_min_scale`` (the two resizers compute the same f32 blends; cv2
  may take another summation order, or its area path at exactly 2×);
- device mold against ``jax.image.scale_and_translate``: within 1e-3
  (the same weights, f32 products summed in other orders). JAX runs op by
  op here: under ``jax.jit`` XLA contracts the sample position's multiply
  and subtract into one FMA, which moves a weight by one ulp of the
  position (7.6e-6 at scale 1.25, up to ~4e-3 on a 0-255 pixel);
- unmold (device f32 and numpy float64): integer boxes, class ids and
  valid flags equal to JAX's, also where a coordinate lands on .5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu.config import DetectorConfig as JConfig
from objectdetection_tpu.data import preprocess as jpre

from objectdetection_torch.config import DetectorConfig as TConfig
from objectdetection_torch.data import preprocess as tpre

torch.set_num_threads(1)

SMALL = dict(image_shape=(128, 128, 3), image_min_dim=100, image_max_dim=128, num_classes=4)
JCFG, TCFG = JConfig(**SMALL), TConfig(**SMALL)


def smooth_image(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([yy * 2, xx * 1.5, 100 + 50 * np.sin(yy / 9) * np.cos(xx / 11)], -1)


@pytest.mark.parametrize("h,w,min_dim,max_dim,min_scale", [
    (64, 80, 100, 128, 0.0), (50, 200, 100, 128, 0.0), (64, 80, 100, 256, 2.5),
    (50, 200, 100, 128, 3.0), (64, 80, 100, 128, 1.1), (100, 100, 100, 200, 1.7),
    (333, 500, 800, 1024, 0.0), (1200, 900, 800, 1024, 0.0), (480, 640, 800, 1024, 0.0),
    (63, 101, 64, 64, 0.0),
])
def test_resize_params_equal_jax(h, w, min_dim, max_dim, min_scale):
    want = [np.asarray(v) for v in jpre.compute_resize_params(h, w, min_dim, max_dim, min_scale)]
    got = [v.numpy() for v in tpre.compute_resize_params(h, w, min_dim, max_dim, min_scale)]
    for g, x in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, x)


# (h, w, config overrides): upscale, downscale, exact 2× downscale, no
# resize, image_min_scale
HOST_CASES = [
    (64, 80, {}),
    (200, 150, {}),
    (256, 192, {}),
    (128, 96, dict(image_min_dim=96)),
    (40, 50, dict(image_min_scale=2.2)),
]


@pytest.mark.parametrize("h,w,over", HOST_CASES)
def test_host_mold_matches_jax_cv2(h, w, over):
    rng = np.random.RandomState(h * 1000 + w)
    img = (rng.rand(h, w, 3) * 255).astype(np.float32)
    jm, jw, js = jpre.mold_image_host(img, JCFG.replace(**over))
    tm, tw, ts = tpre.mold_image_host(img, TCFG.replace(**over))
    assert ts == js
    np.testing.assert_array_equal(tw, jw)
    assert tm.dtype == np.float32 and tm.shape == jm.shape
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-3)


def test_host_mold_exact_2x_is_an_area_mean():
    # cv2 takes its area path at exactly 2×; the blend gives the same 2×2 means
    img = (np.random.RandomState(5).rand(256, 256, 3) * 255).astype(np.float32)
    tm, tw, ts = tpre.mold_image_host(img, TCFG)
    assert ts == 0.5 and list(tw) == [0, 0, 128, 128]
    want = img.reshape(128, 2, 128, 2, 3).mean((1, 3)) - np.float32(TCFG.mean_pixel)
    np.testing.assert_allclose(tm, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape", [(5, 7), (7, 5), (28, 28)])
@pytest.mark.parametrize("size", [(3, 4), (14, 14), (31, 17), (56, 56), (1, 9)])
def test_resize_bilinear_matches_cv2(shape, size):
    import cv2  # the test's oracle only

    m = np.random.RandomState(sum(shape) + sum(size)).rand(*shape).astype(np.float32)
    want = cv2.resize(m, (size[1], size[0]), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(tpre.resize_bilinear(m, size), want, rtol=0, atol=1e-6)


# canvases: content shapes inside a static canvas of 160², molded to 128²
DEVICE_CASES = [(64, 96), (100, 80), (160, 120), (128, 128), (37, 151)]


def _canvases(shapes, seed=2, smooth=False):
    rng = np.random.RandomState(seed)
    canvases = np.zeros((len(shapes), 160, 160, 3), np.float32)
    for i, (h, w) in enumerate(shapes):
        canvases[i, :h, :w] = smooth_image(h, w) if smooth else rng.rand(h, w, 3) * 255
    return canvases, np.asarray(shapes, np.int32)


def test_device_mold_matches_jax():
    canvases, shapes = _canvases(DEVICE_CASES)
    jm, jmeta = jpre.mold_batch_device(jnp.asarray(canvases), jnp.asarray(shapes), JCFG)
    tm, tmeta = tpre.mold_batch_device(torch.from_numpy(canvases), torch.from_numpy(shapes), TCFG)
    np.testing.assert_array_equal(tmeta.window.numpy(), np.asarray(jmeta.window))
    np.testing.assert_array_equal(tmeta.scale.numpy(), np.asarray(jmeta.scale))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(tmeta.to_vector().numpy(), np.asarray(jmeta.to_vector()))


def test_device_mold_single_matches_jax():
    canvases, shapes = _canvases([(64, 96)], seed=4)
    jm, jw, js = jpre.mold_image_device(jnp.asarray(canvases[0]), jnp.asarray(shapes[0]), JCFG)
    tm, tw, ts = tpre.mold_image_device(torch.from_numpy(canvases[0]),
                                        torch.from_numpy(shapes[0]), TCFG)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert float(ts) == float(js)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-3)


def test_weights_match_scale_and_translate():
    # the per-axis weights reproduce JAX's resampler on a unit impulse basis
    from jax._src.image.scale import compute_weight_mat, _fill_triangle_kernel

    for size_in, size_out, scale, t in [(160, 128, 0.8, 0.0), (160, 128, 1.5625, 14.0),
                                        (90, 128, 1.28, 6.0), (40, 128, 3.1, 1.5)]:
        want = np.asarray(compute_weight_mat(size_in, size_out, jnp.float32(scale),
                                             jnp.float32(t), _fill_triangle_kernel, True))
        got = tpre.scale_translate_weights(size_in, size_out, torch.tensor(scale),
                                           torch.tensor(t)).numpy()
        np.testing.assert_allclose(got.T, want, rtol=0, atol=1e-6)


def test_device_and_host_molds_agree_on_a_smooth_image():
    # the criteria of the JAX package's own parity test of its two molds
    h0, w0 = 64, 96
    canvases, shapes = _canvases([(h0, w0)], smooth=True)
    hm, hw, hs = tpre.mold_image_host(smooth_image(h0, w0), TCFG)
    dm, dw, ds = tpre.mold_image_device(torch.from_numpy(canvases[0]),
                                        torch.from_numpy(shapes[0]), TCFG)
    assert abs(float(ds) - hs) < 1e-5
    np.testing.assert_allclose(dw.numpy(), hw, atol=1.0)
    y1, x1, y2, x2 = hw
    gap = np.abs(dm.numpy()[y1 + 2: y2 - 2, x1 + 2: x2 - 2] - hm[y1 + 2: y2 - 2, x1 + 2: x2 - 2])
    assert gap.mean() < 6.0


def _detections(seed, n=12):
    rng = np.random.RandomState(seed)
    det = np.zeros((n + 3, 6), np.float32)
    corners = np.sort(rng.rand(n, 2, 2), axis=1).transpose(0, 2, 1).reshape(n, 4)
    det[:n, :4] = corners
    det[:n, 4] = rng.randint(0, 4, n)
    det[:n, 5] = rng.rand(n) * 0.5 + 0.5
    det[n - 1, :4] = [0.3, 0.3, 0.3, 0.6]  # zero height: invalid
    return det


UNMOLD_CASES = [
    (np.array([14.0, 1.0, 114.0, 126.0], np.float32), (128, 128), (64, 80)),
    (np.array([0.0, 0.0, 128.0, 128.0], np.float32), (128, 128), (300, 200)),
    (np.array([170.0, 0.0, 853.0, 1024.0], np.float32), (1024, 1024), (480, 640)),
]


@pytest.mark.parametrize("case", range(len(UNMOLD_CASES)))
def test_unmold_matches_jax(case):
    window, image_shape, orig = UNMOLD_CASES[case]
    det = _detections(case)
    jb, jc, js, jv = jpre.unmold_detections(jnp.asarray(det), jnp.asarray(window), image_shape,
                                            jnp.asarray(orig))
    tb, tc, ts, tv = tpre.unmold_detections(torch.from_numpy(det), torch.from_numpy(window),
                                            image_shape, torch.tensor(orig))
    nb, nc, ns, nv = tpre.unmold_detections_np(det, window, image_shape, orig)
    wb, wc, ws, wv = jpre.unmold_detections_np(det, window, image_shape, orig)
    for got, want in ((tb.numpy(), jb), (tc.numpy(), jc), (tv.numpy(), jv),
                      (nb, wb), (nc, wc), (nv, wv)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert tb.dtype == torch.int32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert jv.any() and not np.asarray(jv).all()


def test_unmold_rounds_half_to_even_as_jax():
    # window = the whole 129² molded image, so the normalized box is the
    # source fraction exactly; (2k+1)/128 · 64 = k + 0.5 lands on halves
    k = np.arange(16)
    det = np.zeros((16, 6), np.float32)
    det[:, 0] = (2 * k + 1) / 128.0 / 4
    det[:, 1] = (2 * k + 1) / 128.0 / 4
    det[:, 2] = (2 * k + 1) / 128.0
    det[:, 3] = (2 * k + 1) / 128.0
    det[:, 4] = 1
    det[:, 5] = 0.9
    window = np.array([0.0, 0.0, 129.0, 129.0], np.float32)
    args = (window, (129, 129), (65, 65))
    jb, jc, _, jv = jpre.unmold_detections(jnp.asarray(det), jnp.asarray(window), (129, 129),
                                            jnp.asarray([65, 65]))
    tb, tc, _, tv = tpre.unmold_detections(torch.from_numpy(det), *args)
    nb, _, _, nv = tpre.unmold_detections_np(det, *args)
    halves = det[:, 2] * 64 + 1
    assert np.all(halves % 1 == 0.5)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(nb, np.asarray(jpre.unmold_detections_np(det, *args)[0]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tb[:, 2].numpy(), np.round(halves).astype(np.int32))


def test_unmold_masks_takes_each_detection_class():
    rng = np.random.RandomState(9)
    masks = rng.rand(5, 6, 6, 4).astype(np.float32)
    det = np.zeros((5, 6), np.float32)
    det[:, 4] = [0, 3, 1, 2, 3]
    want = jpre.unmold_masks(jnp.asarray(masks), jnp.asarray(det), None, (128, 128))
    got = tpre.unmold_masks(torch.from_numpy(masks), torch.from_numpy(det))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_image_meta_vector_layout_matches_jax():
    fields = dict(image_id=[3], original_shape=[[64, 80, 3]], image_shape=[[128, 128, 3]],
                  window=[[14.0, 1, 114, 126]], scale=[1.5625],
                  active_class_ids=np.ones((1, 4), np.int32))
    j = jpre.ImageMeta(**{k: jnp.asarray(v) for k, v in fields.items()}).to_vector()
    t = tpre.ImageMeta(**{k: torch.as_tensor(np.asarray(v)) for k, v in fields.items()})
    np.testing.assert_array_equal(t.to_vector().numpy(), np.asarray(j))
