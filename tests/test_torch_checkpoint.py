"""The port's checkpoints, int8 artifacts and h5 loader against the JAX package's.

- h5: a synthetic matterport-layout h5 (written as tests/test_checkpoint.py
  writes one) loaded by the port equals JAX's ``load_matterport_h5``
  followed by ``flax_to_state_dict``, bit for bit: the whole file, the
  ``HEADS_LAYERS`` skip, the non-strict zeroing, and the Keras deconv
  (also held against Keras' deconv semantics directly, within 1e-5). A
  missing layer or a wrong shape raises as in JAX.
- ``cast_params_for_inference``: the bf16 bits equal JAX's, and the port's
  forward on the cast state dict matches JAX's on its cast tree (discrete
  outputs equal, floats within 1e-4).
- A ``TrainState`` round trip: one step after loading equals one step
  without the save, exactly (same CPU, same inputs and noise).
- ``save_quantized`` / ``load_quantized``: identical tensors, and
  ``quant_meta.json`` byte-equal to JAX's for the same config.
"""

import json

import h5py
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from objectdetection_tpu import checkpoint as jck
from objectdetection_tpu import detector as jdet
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES

from objectdetection_torch import checkpoint as tck
from objectdetection_torch import detector as tdet
from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.convert import flax_to_state_dict, init_params, split_collections

torch.set_num_threads(1)

SMALL = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
             pre_nms_rois_count=128, post_nms_rois_training=48, post_nms_rois_inference=32,
             train_rois_per_image=8, rpn_train_anchors_per_image=32, max_gt_objects=4,
             compute_dtype="float32")
JCFG, TCFG = J_SHAPES.replace(**SMALL), T_SHAPES.replace(**SMALL)


@pytest.fixture(scope="module")
def variables():
    return jax.tree.map(np.asarray, jdet.init_variables(JCFG, jax.random.PRNGKey(0)))


def synth_h5(path, variables):
    """A matterport-layout h5 of the model's shapes (as tests/test_checkpoint.py)."""
    rng = np.random.RandomState(7)
    with h5py.File(path, "w") as f:
        for p, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
            keys = [getattr(k, "key", str(k)) for k in p]
            layer, leaf_name = keys[-2], keys[-1]
            if layer.startswith("rpn_"):
                grp = f.require_group("rpn_model").require_group(layer)
            else:
                grp = f.require_group(layer).require_group(layer)
            shape = np.asarray(leaf).shape
            is_bn = layer.startswith("bn") or "_bn" in layer
            name = jck._BN_LEAF_MAP[leaf_name] if is_bn else jck._CONV_LEAF_MAP[leaf_name]
            if name in grp:
                continue
            if leaf_name == "kernel" and layer == "mrcnn_class_conv1":
                shape = (7, 7, shape[0] // 49, shape[1])
            elif leaf_name == "kernel" and layer == "mrcnn_class_conv2":
                shape = (1, 1, shape[0], shape[1])
            elif leaf_name == "kernel" and layer == "mrcnn_mask_deconv":
                shape = (shape[0], shape[1], shape[3], shape[2])
            grp.create_dataset(name, data=rng.randn(*shape).astype(np.float32))


@pytest.fixture(scope="module")
def h5_path(variables, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("h5") / "w.h5")
    synth_h5(path, variables)
    return path


def assert_same_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("skip", [None, "heads"])
def test_h5_load_equals_jax_then_convert(variables, h5_path, skip):
    skip_layers = jck.HEADS_LAYERS if skip else None
    want = flax_to_state_dict(jax.tree.map(np.asarray, jck.load_matterport_h5(
        h5_path, variables, skip_layers=skip_layers)))
    base = flax_to_state_dict(variables)
    got = tck.load_matterport_h5(h5_path, base, skip_layers=skip_layers)
    assert_same_state(got, want)
    changed = [k for k in base if not torch.equal(base[k], got[k])]
    kept = [k for k in base if torch.equal(base[k], got[k])]
    if skip:
        assert "mrcnn.mrcnn_class_logits.weight" in kept
        assert "fpn.resnet.conv1.weight" in changed
    else:
        assert not kept  # every tensor has an h5 entry
    assert "mrcnn_mask.mrcnn_mask_deconv.weight" in changed


def test_h5_missing_layer_raises(variables, tmp_path):
    path = str(tmp_path / "partial.h5")
    with h5py.File(path, "w") as f:
        f.require_group("conv1").require_group("conv1")
    base = flax_to_state_dict(variables)
    with pytest.raises(KeyError):
        jck.load_matterport_h5(path, variables, strict=True)
    with pytest.raises(KeyError):
        tck.load_matterport_h5(path, base, strict=True)
    assert_same_state(tck.load_matterport_h5(path, base, strict=False), base)


def test_h5_shape_mismatch_raises_or_zeroes_as_jax(variables, tmp_path):
    path = str(tmp_path / "bad.h5")
    synth_h5(path, variables)
    with h5py.File(path, "r+") as f:
        del f["conv1"]["conv1"]["kernel:0"]
        f["conv1"]["conv1"].create_dataset("kernel:0", data=np.ones((3, 3, 3, 64), np.float32))
    base = flax_to_state_dict(variables)
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.load_matterport_h5(path, base)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jck.load_matterport_h5(
        path, variables, strict=False)))
    got = tck.load_matterport_h5(path, base, strict=False)
    assert_same_state(got, want)
    assert not got["fpn.resnet.conv1.weight"].any()


def test_h5_deconv_reproduces_keras_conv2dtranspose():
    # Keras' 2×2 stride-2 deconv stores (kh, kw, out, in); loaded through the
    # h5 path, F.conv_transpose2d must give Keras' output
    rng = np.random.RandomState(0)
    cin, cout = 3, 5
    x = rng.randn(1, 4, 4, cin).astype(np.float32)
    k_keras = rng.randn(2, 2, cout, cin).astype(np.float32)
    expected = np.zeros((1, 8, 8, cout), np.float32)
    for i in range(4):
        for j in range(4):
            for dy in range(2):
                for dx in range(2):
                    expected[0, 2 * i + dy, 2 * j + dx] = x[0, i, j] @ k_keras[dy, dx].T
    flax_k = tck._adapt_shape("mrcnn_mask_deconv", "kernel", k_keras, (2, 2, cin, cout), True)
    w = torch.from_numpy(np.array(tck._relayout(("mrcnn_mask_deconv", "kernel"), flax_k)))
    out = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, stride=2)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), expected, atol=1e-5)


def test_cast_params_for_inference_bits_equal_jax(variables):
    want = flax_to_state_dict(jax.tree.map(
        lambda a: np.asarray(a).astype(np.float32),
        jck.cast_params_for_inference(variables)))
    base = flax_to_state_dict(variables)
    got = tck.cast_params_for_inference(base)
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    for k in want:  # JAX's bf16, widened to f32 exactly, against the port's
        assert torch.equal(got[k].to(torch.float32), want[k]), k
    assert got["fpn.resnet.bn_conv1.var"].dtype == torch.bfloat16  # statistics too
    sd = {"w": torch.ones(2), "k": torch.ones(2, dtype=torch.int8)}
    assert tck.cast_params_for_inference(sd)["k"].dtype == torch.int8


def test_cast_state_serves_as_jax_serves_its_cast_tree(variables):
    # the port's forward on the cast state dict (bf16 weights and BatchNorm
    # statistics, f32 compute) against JAX's on its cast tree: discrete
    # outputs equal, floats within 1e-4 (the inference parity's tolerance)
    import functools

    import jax.numpy as jnp

    jcfg, tcfg = (c.replace(detection_min_threshold=0.0) for c in (JCFG, TCFG))
    cast = tck.cast_params_for_inference(flax_to_state_dict(variables))
    images = np.random.RandomState(1).uniform(-60, 60, (1, 64, 64, 3)).astype(np.float32)
    windows = np.array([[0.0, 0.0, 64.0, 64.0]], np.float32)
    fwd = jax.jit(functools.partial(jdet.forward_inference, config=jcfg, with_masks=True))
    want = fwd(jck.cast_params_for_inference(variables), jnp.asarray(images),
               jnp.asarray(windows))
    got = tdet.make_infer_fn(tcfg, device="cpu")(cast, images, windows)
    assert int(got.valid.sum()) > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.class_ids.numpy(), np.asarray(want.class_ids))
    for k in ("boxes", "scores", "masks"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-4, atol=1e-4)


def train_batch(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.uniform(-60, 60, (2, 64, 64, 3)).astype(np.float32)
    lo = rng.uniform(0.05, 0.5, (2, 4, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.2, 0.45, (2, 4, 2))], -1).astype(np.float32)
    cls = np.array([[1, 2, 3, 0], [2, 1, 0, 0]], np.int32)
    return tdet.TrainBatch(torch.from_numpy(images), torch.from_numpy(boxes),
                           torch.from_numpy(cls))


def test_train_state_round_trip_steps_the_same(tmp_path):
    cfg = TCFG.replace(train_append_gt=True)
    params, stats, _ = split_collections(init_params(cfg, torch.Generator().manual_seed(3), "cpu"))
    from objectdetection_torch import optim

    state = tdet.TrainState(params, stats, optim.init(params), 0)
    step = tdet.make_train_step(cfg, device="cpu")
    batch = train_batch()
    state, _ = step(state, batch, torch.Generator().manual_seed(1))  # a nonzero trace
    tck.save_checkpoint(str(tmp_path / "ck"), state)
    like = tdet.create_train_state(cfg, device="cpu")
    loaded = tck.load_checkpoint(str(tmp_path / "ck"), like)
    assert loaded.step == 1 and loaded.opt_state.count == state.opt_state.count
    a, ma = step(state, batch, torch.Generator().manual_seed(2))
    b, mb = step(loaded, batch, torch.Generator().manual_seed(2))
    for x, y in ((a.params, b.params), (a.opt_state.trace, b.opt_state.trace),
                 (a.batch_stats, b.batch_stats), (ma, mb)):
        assert set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in x)
    assert a.step == b.step == 2


def test_load_checkpoint_refuses_another_structure(tmp_path):
    state = tdet.create_train_state(TCFG, device="cpu")
    tck.save_checkpoint(str(tmp_path / "ck"), state)
    other = tdet.create_train_state(TCFG.replace(num_classes=5), device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tck.load_checkpoint(str(tmp_path / "ck"), other)


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantized_artifact_round_trip_and_meta_equal_jax(tmp_path, per_channel):
    jcfg = JCFG.replace(quantized_inference=True, per_channel_acts=per_channel)
    tcfg = TCFG.replace(quantized_inference=True, per_channel_acts=per_channel)
    sd = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    sd["fpn.resnet.conv1.weight"] = sd["fpn.resnet.conv1.weight"].to(torch.int8)
    tck.save_quantized(str(tmp_path / "t"), sd, tcfg)
    back = tck.load_quantized(str(tmp_path / "t"))
    assert_same_state(back, sd)
    # JAX's artifact of a one-leaf tree writes the same quant_meta.json
    jck.save_quantized(str(tmp_path / "j"), {"quant": {"s": np.ones(2, np.float32)}}, jcfg)
    got = (tmp_path / "t" / "quant_meta.json").read_bytes()
    assert got == (tmp_path / "j" / "quant_meta.json").read_bytes()
    assert tck.load_quant_meta(str(tmp_path / "t")) == json.loads(got)
    assert tck.load_quant_meta(str(tmp_path)) is None
