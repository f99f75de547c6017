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


# ---------------------------------------------------------------- the fused int8 conv
#
# ops/int8_conv.py: int8_conv_fused_plain with each epilogue against the
# unfused sequence the port ran before the epilogue was fused (QuantConv's
# bias epilogue, FrozenBatchNorm on NCHW, the residual add, ReLU,
# quantize_nchw), bit for bit; a model of csrc/int8_conv.cu's tap walk and
# epilogue arithmetic against the plain version; the restructured int8
# BottleneckBlock against its unfused chain; the counters on one call.

# (kh, stride, padding, cin, cout, per_channel, epilogue, dtype): SAME at
# stride 2 on 9x10 pads (1, 1) x (0, 1); cin 3 and 80 are no multiple of 16
# or 64 (the kernel pads the first, and its K chunks cross taps at both);
# cout 18 is the RPN head's
FUSED_CASES = [
    (3, 1, None, 16, 8, False, "bias", "bfloat16"),
    (3, 2, None, 32, 18, True, "bias", "bfloat16"),
    (3, 1, ((1, 2), (0, 1)), 16, 8, True, "bias", "float32"),
    (7, 2, 3, 3, 16, False, "bias", "bfloat16"),
    (1, 2, None, 48, 24, True, "proj", "bfloat16"),
    (1, 1, None, 64, 64, True, "ab", "bfloat16"),
    (3, 1, None, 80, 64, False, "ab", "bfloat16"),
    (1, 1, None, 32, 64, True, "c_proj", "bfloat16"),
    (1, 1, None, 32, 64, False, "c_id", "bfloat16"),
    (1, 1, None, 32, 64, True, "c_id", "bfloat16"),
    (3, 1, None, 16, 64, True, "c_id", "float32"),
]


def fused_case(kh, stride, padding, cin, cout, pc, epilogue, dtype, seed=11):
    """(x8, k8, arguments of int8_conv_fused as a dict): sums of ~1 after
    ``post``, BatchNorm near 1, scales that clip a few codes."""
    from objectdetection_torch.ops import int8_conv as ic

    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    x8 = torch.randint(-128, 128, (2, 9, 10, cin), generator=g, dtype=torch.int8)
    k8 = torch.randint(-127, 128, (cout, cin, kh, kh), generator=g, dtype=torch.int8)
    post = torch.rand(cout, generator=g) * 2 / (128 * 64 * (kh * kh * cin) ** 0.5)
    bias = torch.randn(cout, generator=g) * 0.1
    scale = lambda: (torch.rand(cout, generator=g) + 0.5) * 3 if pc else torch.tensor(2.0)
    kw = dict(stride=stride, padding=padding, dtype=dt)
    if epilogue != "bias":
        kw["bn"] = (torch.rand(cout, generator=g) + 0.5, torch.randn(cout, generator=g) * 0.1)
    if epilogue in ("ab", "c_proj", "c_id"):
        kw.update(relu=True, out_scale=scale())
    ho, wo = ic.Q.int8_conv(x8, k8, stride, padding).shape[1:3]
    if epilogue == "c_proj":
        kw["residual"] = (torch.randn(2, ho, wo, cout, generator=g) * 2).to(dt)
    if epilogue == "c_id":
        kw["residual"] = (torch.randint(-128, 128, (2, ho, wo, cout), generator=g,
                                        dtype=torch.int8), scale())
    return x8, k8, post, bias, kw


def unfused_chain(x8, k8, post, bias, stride=1, padding=None, bn=None, residual=None,
                  relu=False, out_scale=None, dtype=torch.bfloat16):
    """The ops the port ran before the epilogue was fused, in NCHW as it ran
    them: QuantConv's int8 path, FrozenBatchNorm, the residual add, ReLU and
    quantize_nchw."""
    from objectdetection_torch.models.backbone import FrozenBatchNorm

    y32 = tq.int8_conv(x8, k8, stride, padding)
    y = tq.nchw((y32.to(torch.float32) * post).to(dtype) + bias.to(dtype))
    if bn is not None:
        mod = FrozenBatchNorm(k8.shape[0])
        mod.folded = lambda: bn
        y = mod(y)
    if isinstance(residual, tuple):
        y = y + tq.nchw(tq.dequantize_act(residual[0], residual[1], dtype))
    elif residual is not None:
        y = y + tq.nchw(residual)
    if relu:
        y = torch.nn.functional.relu(y)
    if out_scale is not None:
        return tq.quantize_nchw(y, out_scale)
    return tq.nhwc(y)


def kernel_model(x8, k8, post, bias, stride=1, padding=None, bn=None, residual=None,
                 relu=False, out_scale=None, dtype=torch.bfloat16):
    """csrc/int8_conv.cu in PyTorch: the A matrix gathered chunk by chunk
    (64 bytes of K, four 16-byte pieces) along each piece's (dy, dx, ci)
    walk, zero where a tap leaves the image or K ends; the kernel's [N][K]
    weights (Cin zero-padded to 16); exact sums; the epilogue on the
    wrapper's vectors in the kernel's order of f32 operations and roundings."""
    from objectdetection_torch.ops import int8_conv as ic

    b, h, w, cin = x8.shape
    n, _, kh, kw = k8.shape
    pad_c = (-cin) % 16
    c = cin + pad_c
    x = torch.nn.functional.pad(x8, (0, pad_c)).to(torch.int64)
    wmat = torch.nn.functional.pad(k8, (0, 0, 0, 0, 0, pad_c)).permute(0, 2, 3, 1).reshape(n, -1)
    k_len = kh * kw * c
    t_, b_, l_, r_ = tq.conv_pads(padding, h, w, kh, stride)
    ho, wo = (h + t_ + b_ - kh) // stride + 1, (w + l_ + r_ - kw) // stride + 1
    m = torch.arange(b * ho * wo)
    img, oy, ox = m // (ho * wo), (m % (ho * wo)) // wo, m % wo
    iy0, ix0 = oy * stride - t_, ox * stride - l_
    chunks = -(-k_len // 64)
    a = torch.zeros(m.numel(), chunks * 64, dtype=torch.int64)
    for piece in range(4):
        kk = piece * 16
        tap = kk // c
        ci, dy, dx = kk - tap * c, tap // kw, tap % kw
        for kt in range(chunks):
            iy, ix = iy0 + dy, ix0 + dx
            ok = (kk < k_len) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            rows = x[img, iy.clamp(0, h - 1), ix.clamp(0, w - 1), ci:ci + 16]
            a[:, kt * 64 + piece * 16: kt * 64 + piece * 16 + 16] = rows * ok[:, None]
            kk, ci = kk + 64, ci + 64
            while ci >= c:
                ci -= c
                dx += 1
                if dx == kw:
                    dx, dy = 0, dy + 1
    wfull = torch.zeros(n, chunks * 64, dtype=torch.int64)
    wfull[:, :k_len] = wmat
    acc = a @ wfull.t()
    assert int(acc.abs().max()) < 2 ** 31
    post_v, bias_v, inv, shift, rs, f = ic._vectors(n, x8.device, dtype, post, bias, bn,
                                                    residual, out_scale)
    f32 = torch.float32
    rnd = (lambda v: v) if dtype == f32 else (lambda v: v.to(torch.bfloat16).to(f32))
    y = rnd(acc.to(torch.int32).to(f32) * post_v)
    y = rnd(y + bias_v)
    if bn is not None:
        y = rnd(rnd(y * inv) + shift)
    if isinstance(residual, tuple):
        y = rnd(y + rnd(residual[0].reshape(-1, n).to(f32) * rs))
    elif residual is not None:
        y = rnd(y + residual.reshape(-1, n).to(f32))
    if relu:
        y = torch.where(y < 0, torch.zeros_like(y), y)
    if out_scale is not None:
        y = torch.clamp(torch.round(y * f), -128, 127).to(torch.int8)
    else:
        y = y.to(dtype)
    return y.view(b, ho, wo, n)


@pytest.mark.parametrize("case", FUSED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_int8_conv_fused_plain_equals_unfused_chain(case):
    from objectdetection_torch.ops import int8_conv as ic

    x8, k8, post, bias, kw = fused_case(*case)
    got = ic.int8_conv_fused(x8, k8, post, bias, **kw)  # the CPU runs the plain version
    want = unfused_chain(x8, k8, post, bias, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    if got.dtype == torch.int8:  # codes spread, a few clip
        assert len(torch.unique(got)) > 20


@pytest.mark.parametrize("case", FUSED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_int8_conv_kernel_model_equals_plain(case):
    from objectdetection_torch.ops import int8_conv as ic

    x8, k8, post, bias, kw = fused_case(*case, seed=5)
    want = ic.int8_conv_fused_plain(x8, k8, post, bias, **kw)
    assert torch.equal(kernel_model(x8, k8, post, bias, **kw), want)


def test_int8_conv_tile_plan_and_cell_convs():
    from objectdetection_torch.ops import int8_conv as ic

    assert [ic.tile(10 ** 6, n) for n in (18, 32, 64, 256, 2048)] == [
        (128, 32), (128, 32), (256, 64), (128, 128), (128, 128)]
    assert ic.tile(3000, 256) == (128, 64)  # 24 x 2 blocks of 128 x 128: fewer than FILL
    assert ic.tile(30000, 64) == (128, 64)  # 118 blocks of 256 x 64
    convs = ic.mask_rcnn_convs(96)
    int8_out = sum(c[-1] for c in convs if c[-2] in ("ab", "c_proj", "c_id"))
    assert (sum(c[-1] for c in convs), int8_out) == (125, 99)
    assert {c[-2] for c in convs} == set(ic.EPILOGUES)
    ops = sum(ic.conv_bound(*c[1:8])[0] * c[-1] for c in convs)
    assert 70.0e12 < ops < 70.2e12  # perfbench/counts.py: 41.3 + 19.9 + 8.9 TOP


SMALL_INT8 = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
                  pre_nms_rois_count=128, post_nms_rois_training=48,
                  post_nms_rois_inference=32, max_gt_objects=4, quantized_inference=True,
                  detection_min_threshold=0.0, detection_post_nms_instances=16)


def _small_int8_state(dtype, per_channel):
    """e2e_small (R50, 64²) quantized: seeded weights with every backbone
    BatchNorm drawn (the residual branches' last scales small, as
    chip_smoke.randomized_params), the port's calibration on two images,
    frozen. Returns (config, frozen state dict, images)."""
    from objectdetection_torch import convert
    from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES

    cfg = T_SHAPES.replace(**SMALL_INT8, compute_dtype=dtype, per_channel_acts=per_channel)
    params = convert.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(9)
    for name in sorted(params):
        mod, _, leaf = name.rpartition(".")
        if f"{mod}.var" not in params or not mod.startswith("fpn.resnet."):
            continue
        n = params[name].shape
        lo, hi = (0.05, 0.15) if mod.endswith("2c") else (0.5, 1.5)
        params[name] = {"scale": lambda: lo + (hi - lo) * torch.rand(n, generator=g),
                        "bias": lambda: 0.1 * torch.randn(n, generator=g),
                        "mean": lambda: 0.1 * torch.randn(n, generator=g),
                        "var": lambda: 0.5 + 1.5 * torch.rand(n, generator=g)}[leaf]()
    images = np.random.RandomState(7).uniform(-60, 60, (2, 64, 64, 3)).astype(np.float32)
    cal = tq.calibrate_variables(params, images, cfg, batch_size=2, device="cpu")
    return cfg, tq.freeze_weights(cal), torch.from_numpy(images)


def unfused_block(block, x):
    """An int8 BottleneckBlock as it ran before its epilogues were fused:
    QuantConv (bias epilogue), then BatchNorm, ReLU, the residual and
    quantize_nchw as separate ops."""
    import torch.nn.functional as F

    cn, bnn = block.names
    m = block._modules
    x8, sx = x
    if block.projection:
        shortcut = m[bnn + "1"](m[cn + "1"](x8, in_scale=sx))
    else:
        shortcut = tq.nchw(tq.dequantize_act(x8, sx, block.quant.dtype))
    y = F.relu(m[bnn + "2a"](m[cn + "2a"](x8, in_scale=sx)))
    y = F.relu(m[bnn + "2b"](m[cn + "2b"](y)))
    y = m[bnn + "2c"](m[cn + "2c"](y))
    return tq.quantize_nchw(F.relu(y + shortcut), block.out_scale), block.out_scale


@pytest.mark.parametrize("dtype,per_channel", [("bfloat16", False), ("bfloat16", True),
                                               ("float32", True)])
def test_int8_block_chain_equals_unfused_blocks(dtype, per_channel):
    from torch.func import functional_call

    from objectdetection_torch.detector import build_model

    cfg, frozen, images = _small_int8_state(dtype, per_channel)
    resnet = build_model(cfg).fpn.resnet
    sub = {k[len("fpn.resnet."):]: v for k, v in frozen.items() if k.startswith("fpn.resnet.")}
    seen = []

    def hook(module, args, out):
        want = unfused_block(module, args[0])
        assert torch.equal(out[0], want[0]) and out[1] is want[1]
        seen.append(len(torch.unique(out[0])))

    handles = [resnet._modules[n].register_forward_hook(hook)
               for names in resnet.stages for n in names]
    x = images.permute(0, 3, 1, 2).to(getattr(torch, dtype)).contiguous(
        memory_format=torch.channels_last)
    try:
        with torch.inference_mode():
            functional_call(resnet, sub, (x,))
    finally:
        for h in handles:
            h.remove()
    assert len(seen) == 16 and min(seen) > 10  # every R50 block, codes spread


def test_int8_conv_counters_over_one_call():
    from objectdetection_torch import detector, metrics
    from objectdetection_torch.ops import int8_conv as ic

    cfg, frozen, images = _small_int8_state("bfloat16", True)
    windows = torch.tensor([[0.0, 0.0, 64.0, 64.0]] * 2)
    before = ic.launches
    with torch.inference_mode(), metrics.collect("cpu") as rec:
        detector.forward_inference(frozen, images, windows, cfg)
    rec.resolve()
    convs = ic.mask_rcnn_convs(2, 64, 5, cfg.detection_post_nms_instances)
    int8_out = sum(c[-1] for c in convs if c[-2] in ("ab", "c_proj", "c_id"))
    assert (rec.counters["int8_conv.launches"], rec.counters["int8_conv.int8_out"]) == (
        sum(c[-1] for c in convs), int8_out) == (74, 48)
    assert ic.launches == before  # the CPU ran the plain version
