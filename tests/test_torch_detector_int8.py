"""The int8 serving path end to end: the port against the JAX package.

The e2e_small config of ``test_golden_regression.py`` (R50, 64², f32
compute) with ``quantized_inference=True``, detection threshold 0 and 16
detections per image, so that rows carry; weights from
``init_variables(cfg, PRNGKey(42))`` with every BatchNorm's scale, bias,
mean and var drawn from a seed (the zero-init ``bn*_branch2c`` scales would
leave every residual branch out of the output). JAX calibrates (4 images,
chunks of 2, percentile 90) and freezes; ``flax_to_state_dict`` carries the
frozen tree across; the port serves it with ``forward_inference`` on the CPU.

- ``int8_align_inputs=False``, per-tensor and per-channel: every discrete
  output is equal (proposals, valid rows, class ids); the pyramid, scores,
  boxes and masks agree closely. JAX's CPU path pools in float and lets the
  box head quantize; the port's int8 epilogue gives the same codes, except
  where XLA's jit contracts a multiply-add in the bilinear blend and a value
  sits on a rounding boundary (a code step in a few of ~10^5). Per channel
  the weights keep the init's BatchNorm: with random BatchNorm, JAX's
  jit-contracted multiply-adds flip single codes (1.5e-5 of C2), and the
  per-channel scales of nearly dead channels amplify them into differences
  of up to 53 steps in C5 between JAX's own jitted and eager runs (the port
  equals the eager run, measured; too slow for this suite).
- ``int8_align_inputs=True``: JAX's CPU path ignores the int8 pyramid, the
  port reads it (the P-levels quantized with the RPN's input scale s_in,
  clipped where a percentile scale is below a value), so the pooled codes
  are those of aligning the dequantized int8 pyramid: within one code step
  of JAX's pooling of it, quantized.
- The port's own ``calibrate_variables`` + ``freeze_weights`` from the float
  state dict, per tensor: scales within 1e-4 relative of JAX's (f32
  convolutions sum in other orders, ~1e-6 per layer, as the float parity
  tests state; measured worst 1.7e-5), with and without the percentile;
  frozen kernels identical. Per channel, the port's scales are held at 1e-4
  relative of JAX's (a small channel's scale at 1e-4 of its tensor's
  largest), the serving test's frozen tree takes its scales from the port's
  calibration (a last-bit difference in a [Cin] scale can move a folded
  kernel code), and ``freeze_weights`` of those scales is bit-equal in both
  frameworks.
- Marked slow: ``fused_bottleneck=True`` (stage 2 fuses at 64²), JAX through
  its interpreted Pallas kernel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu import detector as jdet
from objectdetection_tpu import quant as jq
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES
from objectdetection_tpu.ops import roi_align as jroi

from objectdetection_torch import detector as tdet
from objectdetection_torch import quant as tq
from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.convert import flax_to_state_dict

torch.set_num_threads(1)

SMALL = dict(
    image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
    pre_nms_rois_count=128, post_nms_rois_training=48, post_nms_rois_inference=32,
    train_rois_per_image=8, rpn_train_anchors_per_image=32, max_gt_objects=4,
    compute_dtype="float32", quantized_inference=True, detection_min_threshold=0.0,
    detection_post_nms_instances=16,
)


def configs(**over):
    return J_SHAPES.replace(**SMALL, **over), T_SHAPES.replace(**SMALL, **over)


def randomize_bn(variables, seed=0):
    """Every FrozenBatchNorm's scale, bias, mean and var from a seed."""
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(np.asarray, variables)

    def walk(p, s):
        if "mean" in s and "var" in s:
            n = s["mean"].shape
            p["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            p["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
            s["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
            return
        for k in s:
            walk(p[k], s[k])

    params = jax.tree.map(np.copy, tree["params"])
    stats = jax.tree.map(np.copy, tree["batch_stats"])
    walk(params, stats)
    return {**tree, "params": params, "batch_stats": stats}


def images(n, seed):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-60.0, 60.0, (n, 64, 64, 3)).astype(np.float32)
    yy, xx = np.mgrid[:64, :64]
    for b in range(n):
        for _ in range(3):
            cy, cx, r = rng.uniform(10, 54), rng.uniform(10, 54), rng.uniform(5, 14)
            img[b][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] += rng.uniform(-80, 80, 3)
    return img


CALIB = images(4, 7)
SERVE = images(2, 123)
WINDOWS = np.tile(np.array([[0.0, 0.0, 64.0, 64.0]], np.float32), (2, 1))


@pytest.fixture(scope="module")
def float_vars():
    jcfg, _ = configs()
    return randomize_bn(jdet.init_variables(jcfg, jax.random.PRNGKey(42)))


@pytest.fixture(scope="module")
def float_vars_pc():
    # the init's BatchNorm: random ones leave channels nearly dead, whose
    # per-channel scales amplify JAX's jit-contracted multiply-adds (module
    # doc); the per-tensor fixture holds the residual branches
    jcfg, _ = configs(per_channel_acts=True)
    return jax.tree.map(np.asarray, jdet.init_variables(jcfg, jax.random.PRNGKey(42)))


def _jax_frozen(variables, per_channel, percentile=90):
    jcfg, _ = configs(per_channel_acts=per_channel)
    cal = jq.calibrate_variables(variables, jnp.asarray(CALIB), jcfg, batch_size=2,
                                 percentile=percentile)
    return jax.tree.map(np.asarray, jq.freeze_weights(cal))


@pytest.fixture(scope="module")
def per_tensor(float_vars):
    return _jax_frozen(float_vars, False)


def _port_calibrated(variables, per_channel, **gates):
    """The port's calibration of ``variables``, written back into the flax
    tree's ``quant`` collection (same paths, same layouts)."""
    _, tcfg = configs(per_channel_acts=per_channel, **gates)
    cal = tq.calibrate_variables(flax_to_state_dict(variables), CALIB, tcfg, batch_size=2,
                                 percentile=90, device="cpu")

    def fill(path, leaf):
        return cal[".".join(p.key for p in path)].numpy()

    return {**variables, "quant": jax.tree_util.tree_map_with_path(fill, variables["quant"])}


@pytest.fixture(scope="module")
def port_cal_pc(float_vars_pc):
    return _port_calibrated(float_vars_pc, True)


@pytest.fixture(scope="module")
def per_channel(port_cal_pc):
    # scales from the port's calibration (held against JAX's below), frozen by JAX
    return jax.tree.map(np.asarray, jq.freeze_weights(port_cal_pc))


def run_both(frozen, **over):
    jcfg, tcfg = configs(**over)
    fwd = jax.jit(functools.partial(jdet.forward_inference, config=jcfg, with_masks=True,
                                    return_intermediates=True))
    jres, jint = fwd(frozen, jnp.asarray(SERVE), jnp.asarray(WINDOWS))
    with torch.inference_mode():
        tres, tint = tdet.forward_inference(
            flax_to_state_dict(frozen), torch.from_numpy(SERVE), torch.from_numpy(WINDOWS),
            tcfg, return_intermediates=True)
    return jres, jint, tres, tint


def check_discrete(jres, jint, tres, tint):
    for k in ("p2", "p3", "p4", "p5", "p6"):
        np.testing.assert_allclose(tint["pyramid"][k].numpy(), np.asarray(jint["pyramid"][k]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tint["proposals"].numpy() != 0,
                                  np.asarray(jint["proposals"]) != 0)
    np.testing.assert_allclose(tint["proposals"].numpy(), np.asarray(jint["proposals"]),
                               atol=1e-6)
    assert int(np.asarray(jres.valid).sum()) > 0
    np.testing.assert_array_equal(tres.valid.numpy(), np.asarray(jres.valid))
    np.testing.assert_array_equal(tres.class_ids.numpy(), np.asarray(jres.class_ids))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores), atol=2e-3)
    np.testing.assert_allclose(tres.boxes.numpy(), np.asarray(jres.boxes), atol=1e-4)
    np.testing.assert_allclose(tres.masks.numpy(), np.asarray(jres.masks), atol=5e-3)


@pytest.mark.parametrize("acts", ["per_tensor", "per_channel"])
def test_int8_serving_matches_jax(acts, request):
    frozen = request.getfixturevalue(acts)
    out = run_both(frozen, int8_align_inputs=False, per_channel_acts=acts == "per_channel")
    check_discrete(*out)
    assert out[3]["roi_pooled"].dtype == torch.int8  # the heads got int8 ROIs
    assert out[3]["mask_pooled"].dtype == torch.int8


def test_int8_align_inputs_within_the_feature_quantization(per_tensor):
    _, jint, tres, tint = run_both(per_tensor)
    np.testing.assert_array_equal(tint["proposals"].numpy() != 0,
                                  np.asarray(jint["proposals"]) != 0)
    sd = flax_to_state_dict(per_tensor)
    s_in = jnp.float32(sd["rpn_model.rpn_conv_shared.act_scale"].numpy())
    _, tcfg = configs()
    feats = [jnp.asarray(tint["pyramid"][f"p{i}"].numpy()) for i in range(2, 6)]
    for key, rois, crop, scale in (
            ("roi_pooled", tint["proposals"], tcfg.pool_shape, "pooled_box_scale"),
            ("mask_pooled", tint["detections"][..., :4], tcfg.mask_pool_shape,
             "pooled_mask_scale")):
        s_out = float(sd[scale])
        deq = [jq.dequantize_act(jq.quantize_act(f, s_in), s_in) for f in feats]
        pooled = jroi.batched_multilevel_roi_align(deq, jnp.asarray(rois.numpy()),
                                                   tcfg.image_shape[:2], crop)
        want = np.asarray(jq.quantize_act(pooled, jnp.float32(s_out)))
        got = tint[key].numpy()
        assert got.dtype == np.int8
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, (key, diff.max())
        assert (diff > 0).mean() < 1e-2
    for field in ("scores", "boxes", "masks"):
        assert torch.isfinite(getattr(tres, field)).all()
    assert int(tres.valid.sum()) > 0


@pytest.mark.parametrize("percentile", [90, None])
def test_port_calibration_matches_jax(float_vars, per_tensor, percentile):
    want = (per_tensor if percentile == 90
            else _jax_frozen(float_vars, False, percentile=None))
    _, tcfg = configs()
    fsd = flax_to_state_dict(float_vars)
    got = tq.freeze_weights(tq.calibrate_variables(fsd, CALIB, tcfg, batch_size=2,
                                                   percentile=percentile, device="cpu"))
    want = flax_to_state_dict(want)
    assert set(got) == set(want)
    n_scales = 0
    for k, v in want.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in tq.ACT_SCALES:
            assert float(v.abs().min()) > 0, k  # every range was recorded
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, err_msg=k)
            n_scales += 1
        else:
            assert torch.equal(got[k], v), k
    assert n_scales > 80


def test_port_per_channel_calibration_matches_jax(float_vars_pc, port_cal_pc):
    jcfg, _ = configs(per_channel_acts=True)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jq.calibrate_variables(
        float_vars_pc, jnp.asarray(CALIB), jcfg, batch_size=2, percentile=90)))
    got = flax_to_state_dict(port_cal_pc)
    assert set(got) == set(want)
    n_scales = 0
    for k, v in want.items():
        if k.rsplit(".", 1)[-1] in tq.ACT_SCALES:
            # a small channel's scale carries the rounding of its whole tensor
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-4 * float(v.abs().max()), err_msg=k)
            n_scales += v.numel() > 1
        else:
            assert torch.equal(got[k], v), k
    assert n_scales > 80  # per-channel [C] act scales, not scalars


def test_port_per_channel_freeze_matches_jax(port_cal_pc, per_channel):
    # the same per-channel scales frozen by both: the [Cin] act fold into
    # every kernel, then per-output-channel int8, bit for bit
    got = tq.freeze_weights(flax_to_state_dict(port_cal_pc))
    want = flax_to_state_dict(per_channel)
    assert set(got) == set(want)
    n_int8 = 0
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        n_int8 += v.dtype == torch.int8
    assert n_int8 == 70


@pytest.mark.slow  # JAX runs the fused blocks through the interpreted Pallas kernel
def test_fused_bottleneck_serving_matches_jax(per_tensor):
    check_discrete(*run_both(per_tensor, int8_align_inputs=False, fused_bottleneck=True))


@pytest.fixture(scope="module")
def float_vars_init():
    jcfg, _ = configs()
    return jax.tree.map(np.asarray, jdet.init_variables(jcfg, jax.random.PRNGKey(42)))


@pytest.mark.parametrize("gates", [
    dict(int8_stem=True),  # the int8 stem: K = 147, padded on the card
    dict(bf16_stages=(2,)),  # stage 2 served in the compute dtype, re-entering int8
    dict(bf16_stages=(3, 4)),  # two float stages in a row: no requant between
    dict(quantize_fpn_p2=False),  # the float P2 convs on the int8 stream
])
def test_backbone_gates_match_jax(float_vars_init, gates):
    # the init's BatchNorm (module doc: random BatchNorm lets JAX's jit drift
    # from its own eager run); scales from the port's calibration of the
    # gate's layout, frozen by JAX
    variables = float_vars_init
    if not gates.get("quantize_fpn_p2", True):  # those two convs are plain float
        fpn = {k: v for k, v in variables["quant"]["fpn"].items()
               if k not in ("fpn_c2p2", "fpn_p2")}
        variables = {**variables, "quant": {**variables["quant"], "fpn": fpn}}
    frozen = jax.tree.map(np.asarray, jq.freeze_weights(
        _port_calibrated(variables, False, **gates)))
    jcfg, tcfg = configs(**gates)
    jm = jdet.build_model(jcfg)
    jfeats = jax.jit(lambda v, x: jm.apply(v, x, method=jm.extract)[0])(
        frozen, jnp.asarray(SERVE))
    with torch.inference_mode():
        tfeats = tdet.forward_inference(
            flax_to_state_dict(frozen), torch.from_numpy(SERVE), torch.from_numpy(WINDOWS),
            tcfg, return_intermediates=True)[1]["pyramid"]
    for i, jf in enumerate(jfeats):
        np.testing.assert_allclose(tfeats[f"p{i + 2}"].numpy(), np.asarray(jf),
                                   rtol=1e-4, atol=1e-4)
