"""The port's int8 primitives and quantized layers against the JAX package.

Same numpy-seeded inputs and weights through ``objectdetection_tpu.quant``
and ``objectdetection_torch.quant``:

- ``quantize_act``, ``dequantize_act`` and ``weight_qparams`` bit-equal;
- ``QuantConv`` / ``QuantDense`` against the flax modules on the same
  params, per-tensor and per-channel, with ``in_scale``, ``return_x8``,
  frozen kernels and ``int8_compute=False``. The convs are small, so JAX's
  f32 simulation of the integer product is exact and the int8 paths agree
  bit for bit (f32 compute); the float calibration path agrees at f32
  rounding;
- ``freeze_weights``: int8 kernels and scales equal to JAX's (here per
  layer; on a whole R50 tree in ``tests/test_torch_detector_int8.py``);
- the integer product itself: exact against int64 on the CPU.

``calibrate_variables`` is held against JAX's there too, sharing its
compiled pipeline.

Bias correction (``recording_means`` / ``record_act_means`` /
``apply_bias_correction``): JAX's ``TestBiasCorrection`` cases on one
QuantConv, the recorded means and corrected biases beside JAX's; and on the
whole e2e_small model (R50, 64², per channel), every recorded input mean
within 1e-5 of its largest element of JAX's, and the corrected biases
within 1e-5 of their largest (the biases start at zero, so the bound is
relative to the correction), from JAX's means and from the port's own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu import quant as jq

from objectdetection_torch import quant as tq

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_dequantize_bit_equal(per_channel):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 5, 6, 8) * 3).astype(np.float32)
    x[0, 0, 0, :4] = [0.5 * 3 / 127, 1.5 * 3 / 127, -2.5 * 3 / 127, 1e9]  # ties, clip
    scale = (rng.uniform(0.5, 4, 8).astype(np.float32) if per_channel
             else np.float32(3.0))
    if per_channel:
        scale[2] = 0.0  # a dead channel quantizes to 0
    want = np.asarray(jq.quantize_act(jnp.asarray(x), jnp.asarray(scale)))
    got = tq.quantize_act(t(x), t(scale)).numpy()
    np.testing.assert_array_equal(got, want)
    want_d = np.asarray(jq.dequantize_act(jnp.asarray(want), jnp.asarray(scale)))
    np.testing.assert_array_equal(tq.dequantize_act(t(want), t(scale)).numpy(), want_d)


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (1, 1, 32, 8), (40, 24)])
def test_weight_qparams_bit_equal(shape):
    k = np.random.RandomState(1).randn(*shape).astype(np.float32)
    k8, sw = jq.weight_qparams(jnp.asarray(k))
    # port layout: output axis first (OIHW, [out, in])
    kp = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
    t8, tsw = tq.weight_qparams(t(kp))
    back = t8.numpy().transpose(2, 3, 1, 0) if k.ndim == 4 else t8.numpy().T
    np.testing.assert_array_equal(back, np.asarray(k8))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(sw))


@pytest.mark.parametrize("m,k,n", [(5, 3, 7), (33, 2050, 24), (17, 1024, 8)])
def test_int8_matmul_is_exact(m, k, n):
    rng = np.random.RandomState(2)
    a = rng.randint(-128, 128, (m, k)).astype(np.int8)
    b = rng.randint(-127, 128, (k, n)).astype(np.int8)
    a[0] = -128
    b[:, 0] = 127  # the extreme product in every term of one output
    want = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(tq.int8_matmul(t(a), t(b)).numpy(), want)


CONV_CASES = [
    # (kernel, stride, cin, cout, per_channel)
    (3, 1, 16, 8, False),
    (3, 1, 16, 8, True),
    (1, 2, 16, 24, False),
    (1, 1, 16, 8, True),
]


def _conv_setup(k, stride, cin, cout, per_channel, seed=3):
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(2, 9, 10, cin)).astype(np.float32)
    kernel = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
    act = (rng.uniform(1.0, 3.0, cin) if per_channel else np.float32(2.5)).astype(np.float32)
    jmod = jq.QuantConv(features=cout, kernel_size=(k, k), strides=(stride, stride),
                        per_channel=per_channel)
    variables = {"params": {"kernel": kernel, "bias": bias},
                 "quant": {"kernel_scale": np.ones(cout, np.float32), "act_scale": act}}
    tmod = tq.QuantConv(cin, cout, k, stride, per_channel=per_channel)
    tmod.load_state_dict({"weight": t(kernel.transpose(3, 2, 0, 1)), "bias": t(bias),
                          "kernel_scale": t(np.ones(cout, np.float32)), "act_scale": t(act)})
    return x, variables, jmod, tmod


@pytest.mark.parametrize("k,stride,cin,cout,pc", CONV_CASES)
def test_quant_conv_int8_path_bit_equal(k, stride, cin, cout, pc):
    x, variables, jmod, tmod = _conv_setup(k, stride, cin, cout, pc)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    xt = t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(nhwc(tmod(xt)), want)
    # a pre-quantized int8 input with its scale, and the shared int8 copy
    x8 = np.asarray(jq.quantize_act(jnp.asarray(x), variables["quant"]["act_scale"]))
    s_in = variables["quant"]["act_scale"]
    want2, (jx8, js) = jmod.apply(variables, jnp.asarray(x8), in_scale=jnp.asarray(s_in),
                                  return_x8=True)
    got2, (tx8, ts) = tmod(t(x8), in_scale=t(s_in), return_x8=True)
    np.testing.assert_array_equal(nhwc(got2), np.asarray(want2))
    np.testing.assert_array_equal(tx8.numpy(), np.asarray(jx8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(nhwc(got2), want)  # same codes either way


@pytest.mark.parametrize("k,stride,cin,cout,pc", CONV_CASES[:2])
def test_quant_conv_frozen_and_bf16_served(k, stride, cin, cout, pc):
    x, variables, jmod, tmod = _conv_setup(k, stride, cin, cout, pc)
    frozen = jq.freeze_weights(variables)
    tfrozen = tq.freeze_weights(tmod.state_dict())
    np.testing.assert_array_equal(
        tfrozen["weight"].numpy().transpose(2, 3, 1, 0), np.asarray(frozen["params"]["kernel"]))
    np.testing.assert_array_equal(tfrozen["kernel_scale"].numpy(),
                                  np.asarray(frozen["quant"]["kernel_scale"]))
    xt = t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    tmod.load_state_dict(tfrozen, assign=True)  # keeps the int8 dtype
    np.testing.assert_array_equal(nhwc(tmod(xt)), np.asarray(jmod.apply(frozen, jnp.asarray(x))))
    # int8_compute=False: float activations, the dequantized int8 kernel
    jf = jq.QuantConv(features=cout, kernel_size=(k, k), strides=(stride, stride),
                      per_channel=pc, int8_compute=False)
    tf = tq.QuantConv(cin, cout, k, stride, per_channel=pc, int8_compute=False)
    tf.load_state_dict(tfrozen, assign=True)
    np.testing.assert_allclose(nhwc(tf(xt)), np.asarray(jf.apply(frozen, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pc", [False, True])
def test_quant_conv_calibration_records_absmax(pc):
    x, variables, jmod, tmod = _conv_setup(3, 1, 16, 8, pc)
    variables["quant"]["act_scale"] = np.zeros_like(variables["quant"]["act_scale"])
    tmod.act_scale.zero_()
    want, m = jmod.apply(variables, jnp.asarray(x), mutable=["quant"])
    xt = t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with tq.calibration():
        got = tmod(xt)
    np.testing.assert_array_equal(tmod.act_scale.numpy(), np.asarray(m["quant"]["act_scale"]))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pc", [False, True])
def test_quant_dense_bit_equal(pc):
    rng = np.random.RandomState(4)
    cin, cout = 48, 24
    x = np.abs(rng.randn(3, 5, cin)).astype(np.float32)
    kernel = (rng.randn(cin, cout) / np.sqrt(cin)).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
    act = (rng.uniform(1.0, 3.0, cin) if pc else np.float32(2.5)).astype(np.float32)
    variables = {"params": {"kernel": kernel, "bias": bias},
                 "quant": {"kernel_scale": np.ones(cout, np.float32), "act_scale": act}}
    jmod = jq.QuantDense(features=cout, per_channel=pc)
    tmod = tq.QuantDense(cin, cout, per_channel=pc)
    tmod.load_state_dict({"weight": t(kernel.T), "bias": t(bias),
                          "kernel_scale": t(np.ones(cout, np.float32)), "act_scale": t(act)})
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    np.testing.assert_array_equal(tmod(t(x)).numpy(), want)
    x8 = np.asarray(jq.quantize_act(jnp.asarray(x), act))
    np.testing.assert_array_equal(tmod(t(x8), t(act)).numpy(), want)  # in_scale
    frozen = jq.freeze_weights(variables)
    tmod.load_state_dict(tq.freeze_weights(tmod.state_dict()), assign=True)
    np.testing.assert_array_equal(tmod.weight.numpy().T, np.asarray(frozen["params"]["kernel"]))
    np.testing.assert_array_equal(tmod(t(x)).numpy(),
                                  np.asarray(jmod.apply(frozen, jnp.asarray(x))))


# ---------------------------------------------------------------- bias correction


def _bias_correction_case(per_channel):
    """JAX's TestBiasCorrection case: one 3×3 VALID QuantConv on nonzero-mean
    inputs, calibrated, its input means recorded, frozen and corrected, in
    both frameworks on the same weights."""
    import flax.linen as nn

    class M(nn.Module):
        @nn.compact
        def __call__(self, x):
            return jq.QuantConv(16, (3, 3), padding="VALID", per_channel=per_channel,
                                name="c")(x)

    import jax

    m = M()
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 24, 24, 8) * (1.0 + np.arange(8)) + 0.7).astype(np.float32)
    v = m.init(jax.random.PRNGKey(3), jnp.asarray(x))
    yf, mut = m.apply(v, jnp.asarray(x), mutable=["quant"])
    v = {**v, "quant": mut["quant"]}
    _, mut2 = m.apply(v, jnp.asarray(x), mutable=["quant", "stats"])
    jmeans = mut2["stats"]
    jfrozen = jq.freeze_weights(v)
    jcorr = jq.apply_bias_correction(jfrozen, v, jmeans)

    tmod = tq.QuantConv(8, 16, 3, padding=0, per_channel=per_channel)
    kernel = np.asarray(v["params"]["c"]["kernel"])
    tmod.load_state_dict({"weight": t(kernel.transpose(3, 2, 0, 1)),
                          "bias": t(np.asarray(v["params"]["c"]["bias"])),
                          "kernel_scale": t(np.ones(16, np.float32)),
                          "act_scale": torch.zeros(8 if per_channel else ())})
    xt = t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with tq.calibration(), tq.recording_means({}) as store:
        tyf = tmod(xt)
    tcal = tmod.state_dict()
    tmeans = {"act_mean": store[tmod]}
    tfrozen = tq.freeze_weights(tcal)
    tcorr = tq.apply_bias_correction(tfrozen, tcal, tmeans)

    def outputs(sd):
        tmod.load_state_dict(sd, assign=True)
        return nhwc(tmod(xt))

    return dict(x=x, yf=np.asarray(yf), tyf=nhwc(tyf), jmeans=jmeans, tmeans=tmeans,
                jfrozen=jfrozen, jcorr=jcorr, tfrozen=tfrozen, tcorr=tcorr,
                tq_out=outputs(tfrozen), tc_out=outputs(tcorr),
                jq_out=np.asarray(m.apply(jfrozen, jnp.asarray(x))),
                jc_out=np.asarray(m.apply(jcorr, jnp.asarray(x))))


@pytest.mark.parametrize("per_channel", [False, True])
def test_bias_correction_shrinks_the_mean_error_as_jax(per_channel):
    r = _bias_correction_case(per_channel)
    # the recorded means and the corrected biases are JAX's
    np.testing.assert_allclose(r["tmeans"]["act_mean"].numpy(),
                               np.asarray(r["jmeans"]["c"]["act_mean"][-1]), rtol=1e-6, atol=1e-6)
    jb = np.asarray(r["jcorr"]["params"]["c"]["bias"])
    np.testing.assert_allclose(r["tcorr"]["bias"].numpy(), jb, rtol=0,
                               atol=1e-5 * np.abs(jb).max())
    # JAX's TestBiasCorrection: the systematic per-channel output offset drops
    ef = np.abs((r["tq_out"] - r["tyf"]).mean(axis=(0, 1, 2)))
    ec = np.abs((r["tc_out"] - r["tyf"]).mean(axis=(0, 1, 2)))
    assert np.mean(ec) < 0.6 * np.mean(ef), (np.mean(ef), np.mean(ec))
    # only the bias changed
    assert torch.equal(r["tfrozen"]["weight"], r["tcorr"]["weight"])
    assert not torch.equal(r["tfrozen"]["bias"], r["tcorr"]["bias"])


def test_bias_correction_is_a_noop_without_means():
    r = _bias_correction_case(False)
    out = tq.apply_bias_correction(r["tfrozen"], r["tfrozen"], {})
    assert all(torch.equal(out[k], r["tfrozen"][k]) for k in r["tfrozen"])


def test_whole_model_bias_correction_matches_jax():
    # e2e_small (R50, 64², f32), quantized per channel: the port calibrates;
    # both frameworks record the input means on the float forward from the
    # same scales and correct the same frozen state
    import jax

    from objectdetection_tpu import detector as jdet
    from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES

    from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
    from objectdetection_torch.convert import flax_to_state_dict

    small = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
                 pre_nms_rois_count=128, post_nms_rois_training=48, post_nms_rois_inference=32,
                 max_gt_objects=4, compute_dtype="float32", quantized_inference=True,
                 per_channel_acts=True, detection_post_nms_instances=16)
    jcfg, tcfg = J_SHAPES.replace(**small), T_SHAPES.replace(**small)
    rng = np.random.RandomState(7)
    images = rng.uniform(-60.0, 60.0, (4, 64, 64, 3)).astype(np.float32)
    jvars = jax.tree.map(np.asarray, jdet.init_variables(jcfg, jax.random.PRNGKey(42)))
    tcal = tq.calibrate_variables(flax_to_state_dict(jvars), images, tcfg, batch_size=2,
                                  device="cpu")

    def fill(tree, prefix=()):
        return {k: fill(v, prefix + (k,)) if isinstance(v, dict)
                else tcal[".".join(prefix + (k,))].numpy() for k, v in tree.items()}

    jcal = {**jvars, "quant": fill(jvars["quant"])}
    jmeans = jax.tree.map(np.asarray, jq.record_act_means(jcal, jnp.asarray(images), jcfg,
                                                          batch_size=2))
    want_means = flax_to_state_dict({"stats": jmeans})
    got_means = tq.record_act_means(tcal, images, tcfg, batch_size=2, device="cpu")
    assert set(got_means) == set(want_means) and len(got_means) > 50
    for k, w in want_means.items():
        scale = float(w.abs().max()) + 1e-6
        np.testing.assert_allclose(got_means[k].numpy(), w.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=k)
    jfrozen = jax.tree.map(np.asarray, jq.freeze_weights(jcal))
    want = flax_to_state_dict(jax.tree.map(np.asarray, jq.apply_bias_correction(
        jfrozen, jcal, jmeans)))
    tfrozen = tq.freeze_weights(tcal)
    same_means = tq.apply_bias_correction(tfrozen, tcal, want_means)
    own_means = tq.apply_bias_correction(tfrozen, tcal, got_means)
    # only biases change
    assert all(torch.equal(own_means[k], v) for k, v in tfrozen.items() if not k.endswith(".bias"))
    moved = 0
    for k, w in want.items():
        if not k.endswith(".bias"):
            continue
        tol = 1e-5 * float(w.abs().max()) + 1e-12
        for got in (same_means[k], own_means[k]):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=tol, err_msg=k)
        moved += int(not torch.equal(w, tfrozen[k]))
    assert moved > 50
