"""The int8 epilogues of ROIAlign (B1's ``out_quant`` and ``in_scale``), plain
path on the CPU, against the JAX package.

- Float input with ``out_quant``: the codes are bit-equal to JAX's
  ``quantize_act`` of the XLA-pooled tensor (op by op, as JAX runs it
  eagerly; bf16 and f32 features, a scalar and a per-position scale map).
  This is the route the heads' own quantization takes on JAX's CPU path.
- int8 input with ``in_scale`` (scalar or per channel): within one code step
  of aligning the dequantized features and quantizing (the dequant moves
  after the blend: f32 rounding on a rounding boundary); with a float
  output, within bf16 rounding of the dequantized align.
- Zero boxes give the Pallas kernel's zero-row fill: the P2 corner,
  quantized with the same map.
- Marked slow: against the interpreted Pallas kernel on the 1024² pyramid of
  ``tests/test_roi_align_pallas.py``, within one code step. That kernel
  blends in bf16 (x-blends rounded, then a bf16 matmul), about 2^-7·|v| from
  the XLA blend; with output scales near the values' absmax (as calibration
  gives) that is under one step. Boxes keep an aspect ratio in [1/2, 2]:
  the Pallas kernel reroutes slivers whose patch does not fit (``no_fit``),
  an approximation the port does not reproduce.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu import quant as jq
from objectdetection_tpu.ops import roi_align as jroi
from objectdetection_tpu.ops.roi_align_pallas import batched_multilevel_roi_align_pallas

from objectdetection_torch.ops import roi_align as troi

torch.set_num_threads(1)

IMAGE = (1024, 1024)  # box sizes spread over all four levels
LEVELS = ((32, 32), (16, 16), (8, 8), (4, 4))
C = 8


def boxes_for(rng, b, r):
    """Random boxes plus zero, flat, full-image and tiny ones."""
    y1x1 = rng.uniform(0, 0.8, (b, r, 2))
    hw = rng.uniform(0, 1, (b, r, 2)) ** 2 * 0.7
    boxes = np.concatenate([y1x1, np.minimum(y1x1 + hw, 1.0)], -1).astype(np.float32)
    q = r // 8
    boxes[:, :q] = 0.0
    boxes[:, q:2 * q, 2] = boxes[:, q:2 * q, 0]
    boxes[:, 3 * q:3 * q + 2] = [0.0, 0.0, 1.0, 1.0]
    boxes[:, 4 * q:5 * q, 2:] = boxes[:, 4 * q:5 * q, :2] + 1e-4
    return boxes


def t(a):
    return torch.from_numpy(np.array(a))


def steps(a, b):
    return np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))


@pytest.mark.parametrize("crop", [(7, 7), (14, 14)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("per_position", [False, True])
def test_float_input_codes_equal_jax_quantize_of_the_pooled(crop, dtype, per_position):
    rng = np.random.RandomState(1)
    feats = [rng.normal(0, 1, (2, h, w, C)).astype(np.float32) for h, w in LEVELS]
    boxes = boxes_for(rng, 2, 64)
    smap = (rng.uniform(0.5, 3.0, (*crop, C)) if per_position
            else np.full((*crop, C), 2.0)).astype(np.float32)
    smap.reshape(-1)[3] = 0.0  # a dead position quantizes to 0
    jf = [jnp.asarray(f).astype(dtype) for f in feats]
    pooled = jroi.batched_multilevel_roi_align(jf, jnp.asarray(boxes), IMAGE, crop)
    want = np.asarray(jq.quantize_act(pooled, jnp.asarray(smap)))
    tdt = getattr(torch, dtype)
    got = troi.batched_multilevel_roi_align([t(f).to(tdt) for f in feats], t(boxes), IMAGE,
                                            crop, out_quant=t(smap))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("crop", [(7, 7), (14, 14)])
@pytest.mark.parametrize("per_channel", [False, True])
def test_int8_input_within_one_step_of_the_dequantized_align(crop, per_channel):
    rng = np.random.RandomState(2)
    s_in = (rng.uniform(1.0, 4.0, C) if per_channel else np.float32(3.0)).astype(np.float32)
    codes = [rng.randint(-128, 128, (2, h, w, C)).astype(np.int8) for h, w in LEVELS]
    boxes = boxes_for(rng, 2, 64)
    s_out = rng.uniform(0.5, 3.0, (*crop, C)).astype(np.float32)
    deq = [jq.dequantize_act(jnp.asarray(c), jnp.asarray(s_in)) for c in codes]
    pooled = jroi.batched_multilevel_roi_align(deq, jnp.asarray(boxes), IMAGE, crop)
    want = np.asarray(jq.quantize_act(pooled, jnp.asarray(s_out)))
    got = troi.batched_multilevel_roi_align([t(c) for c in codes], t(boxes), IMAGE, crop,
                                            out_quant=t(s_out), in_scale=t(s_in))
    d = steps(got.numpy(), want)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 1e-2
    # float output: the dequant alone, rounded to bf16
    got_f = troi.batched_multilevel_roi_align([t(c) for c in codes], t(boxes), IMAGE, crop,
                                              in_scale=t(s_in))
    assert got_f.dtype == torch.bfloat16
    np.testing.assert_allclose(got_f.float().numpy(), np.asarray(pooled),
                               rtol=2 ** -8, atol=1e-6)


def test_zero_boxes_get_the_quantized_p2_corner():
    rng = np.random.RandomState(3)
    s_in = rng.uniform(1.0, 4.0, C).astype(np.float32)
    codes = [rng.randint(-128, 128, (2, h, w, C)).astype(np.int8) for h, w in LEVELS]
    boxes = boxes_for(rng, 2, 16)
    boxes[:, :5] = 0.0
    crop = (7, 7)
    s_out = rng.uniform(0.5, 3.0, (*crop, C)).astype(np.float32)
    got = troi.batched_multilevel_roi_align([t(c) for c in codes], t(boxes), IMAGE, crop,
                                            out_quant=t(s_out), in_scale=t(s_in)).numpy()
    # the Pallas wrapper's fill (roi_align_pallas.py:809-830): round(corner · map)
    post = np.where(s_out > 0, 127.0 / np.maximum(s_out, 1e-30), 0.0) * (s_in / 127.0)
    corner = codes[0][:, 0, 0, :].astype(np.float32)
    fill = np.clip(np.round(corner[:, None, None, :] * post[None]), -128, 127)
    for b in range(2):
        for r in range(5):
            np.testing.assert_allclose(got[b, r], fill[b], atol=1)
    m = troi.epilogue_map(t(s_out), t(s_in), crop, C, "cpu").numpy()
    want = np.clip(np.round(corner[:, None, None, :] * m[None]), -128, 127)
    for b in range(2):
        assert (got[b, :5] == want[b]).all()


def test_inputs_and_scales_must_agree():
    feats = [torch.zeros(1, h, w, C) for h, w in LEVELS]
    boxes = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="in_scale"):
        troi.batched_multilevel_roi_align(feats, boxes, IMAGE, (7, 7),
                                          in_scale=torch.tensor(1.0))
    with pytest.raises(ValueError, match="in_scale"):
        troi.batched_multilevel_roi_align([f.to(torch.int8) for f in feats], boxes, IMAGE,
                                          (7, 7), out_quant=torch.ones(7, 7, C))


@pytest.mark.slow  # interprets the Pallas kernel over a 1024² pyramid
@pytest.mark.parametrize("int8_in", [False, True])
def test_matches_the_interpreted_pallas_kernel(int8_in):
    rng = np.random.RandomState(0)
    c = 128
    feats = [rng.randn(1, s, s, c).astype(np.float32) for s in (256, 128, 64, 32)]
    size = np.exp(rng.uniform(np.log(0.01), np.log(0.8), (1, 24, 1)))
    ar = np.exp(rng.uniform(np.log(0.5), np.log(2.0), (1, 24, 1)))
    y1x1 = rng.uniform(0, 1 - size, (1, 24, 2))
    hw = np.concatenate([size * ar, size / ar], -1)
    boxes = np.concatenate([y1x1, np.minimum(y1x1 + hw, 1.0)], -1).astype(np.float32)
    boxes[:, -4:] = 0.0
    crop = (7, 7)
    s_out = rng.uniform(4.0, 6.0, (*crop, c)).astype(np.float32)
    if int8_in:
        s_in = rng.uniform(4.0, 6.0, c).astype(np.float32)
        inputs = [np.asarray(jq.quantize_act(jnp.asarray(f), s_in)) for f in feats]
        kw_j, kw_t = dict(in_scale=jnp.asarray(s_in)), dict(in_scale=t(s_in))
        tin = [t(f) for f in inputs]
    else:
        inputs = [np.asarray(jnp.asarray(f).astype(jnp.bfloat16)) for f in feats]
        kw_j, kw_t = {}, {}
        tin = [t(f.astype(np.float32)).to(torch.bfloat16) for f in inputs]
    want = batched_multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in inputs], jnp.asarray(boxes), IMAGE, crop, interpret=True,
        out_quant=jnp.asarray(s_out), **kw_j)
    got = troi.batched_multilevel_roi_align(tin, t(boxes), IMAGE, crop, out_quant=t(s_out),
                                            **kw_t)
    d = steps(got.numpy(), want)
    assert d.max() <= 1, d.max()
