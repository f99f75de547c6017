"""The port's Faster R-CNN family (VGG16, ZF anchors) against the JAX package.

Configs of tests/test_faster_rcnn.py (64² images for the network, the
default 224² for the proposal layer alone), f32. Weights are the port's
``init_faster_rcnn_params`` relaid into the flax tree (``to_flax``); inputs
are drawn with numpy from seeds, with untied scores. JAX runs op by op
(no ``jit``) except for the training step, which it jits as its own test
does.

Tolerances, stated:
- VGG16 maps and RPN outputs within rtol/atol 1e-4;
- proposals within 1e-4 px, valid flags identical (through the whole
  forward, plus what the RPN deltas' difference carries through the decode);
- detections: valid flags and class ids identical, boxes within 1e-3 px,
  scores within 1e-5;
- training: losses within rtol 1e-4, every gradient leaf within 2e-3 of its
  L2 norm, parameters after each of two steps within rtol 1e-5 / atol 1e-6
  (tests/test_torch_train.py's bounds);
- the TF goldens at tests/test_reference_goldens.py's tolerances.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_reference_goldens as ref
from objectdetection_tpu import faster_rcnn_train as jft
from objectdetection_tpu.config import FasterRCNNConfig as JConfig
from objectdetection_tpu.models import faster_rcnn as jfr
from objectdetection_tpu.models import vgg16 as jvgg

from objectdetection_torch import faster_rcnn_train as tft
from objectdetection_torch.config import FasterRCNNConfig as TConfig
from objectdetection_torch.convert import (
    flax_to_state_dict, init_faster_rcnn_params, train_state_from_flax,
)
from objectdetection_torch.models import faster_rcnn as tfr
from objectdetection_torch.models import vgg16 as tvgg

torch.set_num_threads(1)

BUDGETS = dict(pre_nms_top_n_test=256, post_nms_top_n_test=32,
               pre_nms_top_n_train=256, post_nms_top_n_train=64)
SMALL = dict(BUDGETS, image_shape=(64, 64, 3))
TRAIN = dict(SMALL, pre_nms_top_n_train=128, post_nms_top_n_train=32,
             train_rois_per_image=8, rpn_train_anchors_per_image=32)
B = 2
FEAT_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-4
GRAD_REL = 2e-3
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def to_flax(state_dict):
    """Port state dict → flax variables (the inverse of flax_to_state_dict
    for convs and dense layers; BatchNorm mean/var go to batch_stats)."""
    out = {}
    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        a = t.detach().numpy()
        if leaf == "weight":
            leaf, a = "kernel", (a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0))
        node = out.setdefault("batch_stats" if leaf in ("mean", "var") else "params", {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(np.ascontiguousarray(a))
    return out


def shapes_of(tree):
    return jax.tree.map(lambda x: tuple(x.shape), tree)


@pytest.fixture(scope="module")
def weights():
    cfg = TConfig(**SMALL)
    sd = init_faster_rcnn_params(cfg, torch.Generator().manual_seed(4), "cpu")
    return sd, to_flax(sd)


def images(seed, h=64, w=64):
    return np.random.RandomState(seed).uniform(-60.0, 60.0, (B, h, w, 3)).astype(np.float32)


# ---------------------------------------------------------------- weights


def test_seeded_init_has_the_flax_tree(weights):
    sd, variables = weights
    model = jfr.FasterRCNN(config=JConfig(**SMALL))
    want = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    assert shapes_of(variables) == shapes_of(dict(want))
    # flax_to_state_dict maps the whole flax tree back, nothing missing or extra
    back = flax_to_state_dict(jax.tree.map(np.asarray, variables))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # initializer families: lecun_normal kernels (truncated at 2 std), zero biases
    for k, v in sd.items():
        if k.endswith(".bias"):
            assert not v.any(), k
        else:
            fan_in = int(np.prod(v.shape[1:]))
            assert abs(float(v.std()) * np.sqrt(fan_in) - 1.0) < 0.15, k


def test_load_vgg_imagenet_npy_matches_jax(weights, tmp_path):
    rng = np.random.RandomState(0)
    blob = {}
    for block, widths in tvgg.VGG16_LAYOUT[:2]:  # a file that names some layers only
        cin = 3 if block == "conv1" else 64
        for ci, width in enumerate(widths):
            blob[f"{block}_{ci + 1}_W"] = rng.randn(3, 3, cin, width).astype(np.float32)
            blob[f"{block}_{ci + 1}_b"] = rng.randn(width).astype(np.float32)
            cin = width
    path = tmp_path / "VGG_imagenet.npy"
    np.save(path, blob, allow_pickle=True)

    sd, _ = weights
    vgg = {k[len("vgg16."):]: v for k, v in sd.items() if k.startswith("vgg16.")}
    want = jvgg.load_vgg_imagenet_npy(str(path), to_flax(vgg))
    got = tvgg.load_vgg_imagenet_npy(str(path), vgg)
    back = flax_to_state_dict(jax.tree.map(np.asarray, want))
    assert set(got) == set(back)
    for k in got:
        assert torch.equal(got[k], back[k]), k
    assert torch.equal(got["conv1_1.weight"],
                       torch.from_numpy(blob["conv1_1_W"].transpose(3, 2, 0, 1)))
    assert torch.equal(got["conv3_1.weight"], vgg["conv3_1.weight"])  # not in the file
    # a whole Faster R-CNN state dict: its leaves under vgg16.
    full = tvgg.load_vgg_imagenet_npy(str(path), sd)
    assert torch.equal(full["vgg16.conv2_2.bias"], got["conv2_2.bias"])
    assert torch.equal(full["fastrcnn.fc1.weight"], sd["fastrcnn.fc1.weight"])


# ---------------------------------------------------------------- anchors, deltas


def test_zf_anchor_grid_matches_jax():
    np.testing.assert_array_equal(tfr.ZF_ANCHORS, jfr.ZF_ANCHORS)
    for hw in ((4, 4), (14, 14), (38, 63)):
        np.testing.assert_array_equal(tfr.zf_grid_anchors(hw, 16), jfr.zf_grid_anchors(hw, 16))
    assert tfr.feature_shape((600, 1000, 3)) == (38, 63)


def test_zf_deltas_match_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(64, 4).astype(np.float32) * 100
    a[:, 2:] += a[:, :2] + 5
    g = rng.rand(64, 4).astype(np.float32) * 100
    g[:, 2:] += g[:, :2] + 5
    d = (rng.randn(64, 4) * 0.3).astype(np.float32)
    np.testing.assert_allclose(tfr.encode_zf_deltas(torch.from_numpy(a), torch.from_numpy(g)),
                               jfr.encode_zf_deltas(jnp.asarray(a), jnp.asarray(g)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tfr.decode_zf_deltas(torch.from_numpy(a), torch.from_numpy(d)),
                               jfr.decode_zf_deltas(jnp.asarray(a), jnp.asarray(d)),
                               rtol=1e-6, atol=1e-4)


# ---------------------------------------------------------------- network


@pytest.mark.parametrize("hw", [(64, 64), (72, 88)])
def test_vgg16_matches_jax(weights, hw):
    # 72×88 pools 9 → 5 and 11 → 6: flax pads the odd high side with -inf
    sd, variables = weights
    x = images(1, *hw)
    want = jvgg.VGG16().apply({"params": variables["params"]["vgg16"]}, jnp.asarray(x))
    vgg = tvgg.VGG16()
    vgg.load_state_dict({k[len("vgg16."):]: v for k, v in sd.items() if k.startswith("vgg16.")})
    got = vgg(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (B, -(-hw[0] // 16), -(-hw[1] // 16), 512)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FEAT_TOL)


def test_rpn_matches_jax(weights):
    sd, variables = weights
    fmap = np.random.RandomState(2).randn(B, 5, 6, 512).astype(np.float32)
    want = jfr.FasterRCNNRPN().apply({"params": variables["params"]["rpn"]}, jnp.asarray(fmap))
    rpn = tfr.FasterRCNNRPN()
    rpn.load_state_dict({k[len("rpn."):]: v for k, v in sd.items() if k.startswith("rpn.")})
    got = rpn(torch.from_numpy(fmap).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **FEAT_TOL)


@pytest.mark.parametrize("training", [False, True])
def test_proposal_layer_matches_jax(training):
    # 224² (14×14 map, 1764 anchors): some boxes fall under the min size
    rng = np.random.RandomState(3)
    fg = rng.rand(B, 14, 14, 9).astype(np.float32)
    deltas = (rng.randn(B, 14, 14, 9, 4) * 0.3).astype(np.float32)
    want_p, want_v = jfr.zf_proposal_layer(jnp.asarray(fg), jnp.asarray(deltas),
                                           JConfig(**BUDGETS), training=training)
    got_p, got_v = tfr.zf_proposal_layer(torch.from_numpy(fg), torch.from_numpy(deltas),
                                         TConfig(**BUDGETS), training=training)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=1e-4)
    assert 0 < int(got_v.sum()) < got_v.numel()  # the budget is not all filled


def test_head_matches_jax_on_fixed_rois(weights):
    sd, variables = weights
    rng = np.random.RandomState(4)
    feats = np.maximum(rng.randn(B, 4, 4, 512), 0).astype(np.float32)
    xy = rng.uniform(-4, 50, (B, 12, 2))
    rois = np.concatenate([xy, xy + rng.uniform(2, 40, (B, 12, 2))], -1).astype(np.float32)
    rois[:, -2:] = 0.0  # zero-padded rows
    head = jfr.FastRCNNHead(num_classes=4)
    want = jax.vmap(lambda f, r: head.apply({"params": variables["params"]["fastrcnn"]},
                                            f, r, (64, 64, 3)))(jnp.asarray(feats),
                                                                jnp.asarray(rois))
    thead = tfr.FastRCNNHead(4)
    thead.load_state_dict({k[len("fastrcnn."):]: v for k, v in sd.items()
                           if k.startswith("fastrcnn.")})
    got = thead(torch.from_numpy(feats), torch.from_numpy(rois), (64, 64, 3))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def forward(weights):
    sd, variables = weights
    x = images(5)
    jcfg, tcfg = JConfig(**SMALL), TConfig(**SMALL)
    want = jfr.FasterRCNN(config=jcfg).apply(variables, jnp.asarray(x))
    got = tfr.apply(sd, torch.from_numpy(x), tcfg)
    return jcfg, tcfg, want, got


def test_forward_matches_jax(forward):
    _, _, want, got = forward
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["proposals_valid"].numpy(),
                                  np.asarray(want["proposals_valid"]))
    assert int(got["proposals_valid"].sum()) > 0
    # the proposal layer holds 1e-4 px on equal inputs (above); here it also
    # carries the RPN deltas' own difference, scaled by the box size it
    # decodes onto: |Δd| · (largest ZF anchor side) · exp(max |d|)
    d_got, d_want = got["rpn_deltas"].detach().numpy(), np.asarray(want["rpn_deltas"])
    side = float((tfr.ZF_ANCHORS[:, 2:] - tfr.ZF_ANCHORS[:, :2] + 1).max())
    carried = float(np.abs(d_got - d_want).max()) * side * float(np.exp(np.abs(d_want).max()))
    np.testing.assert_allclose(got["proposals"].numpy(), np.asarray(want["proposals"]),
                               rtol=0, atol=1e-4 + carried)
    for k in ("feature_map", "rpn_logits", "fg_probs", "rpn_deltas", "class_logits",
              "class_probs", "bbox"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   err_msg=k, **FEAT_TOL)


@pytest.mark.parametrize("score_threshold", [0.0, 0.26])
def test_detections_match_jax(forward, score_threshold):
    jcfg, tcfg, want, got = forward
    jd = jfr.faster_rcnn_detections(want, jcfg, score_threshold=score_threshold)
    td = tfr.faster_rcnn_detections(got, tcfg, score_threshold=score_threshold)
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(td.class_ids.numpy(), np.asarray(jd.class_ids))
    np.testing.assert_allclose(td.boxes.detach().numpy(), np.asarray(jd.boxes), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(td.scores.detach().numpy(), np.asarray(jd.scores), rtol=0,
                               atol=1e-5)
    assert 0 < int(td.valid.sum())


def test_infer_fn_runs_the_forward_and_detections(weights):
    sd, _ = weights
    cfg = TConfig(**SMALL)
    x = images(5)
    outputs, det = tfr.make_infer_fn(cfg, score_threshold=0.0, device="cpu")(sd, x)
    want = tfr.apply(sd, torch.from_numpy(x), cfg)
    assert torch.equal(outputs["class_probs"], want["class_probs"])
    ref_det = tfr.faster_rcnn_detections(want, cfg, score_threshold=0.0)
    for a, b in zip(det, ref_det):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="params must live on"):
        tfr.make_infer_fn(cfg, device="meta")(sd, x)


# ---------------------------------------------------------------- training


def make_batch():
    rng = np.random.RandomState(7)
    x = images(8)
    # one large box an image so that the second stage samples positives
    boxes = np.array([[[2, 3, 60, 61], [20, 30, 44, 58], [0, 0, 0, 0]],
                      [[4, 1, 62, 57], [10, 10, 34, 40], [30, 5, 50, 25]]], np.float32)
    boxes[..., :2] += rng.uniform(0, 1, (B, 3, 2)).astype(np.float32)
    cls = np.array([[1, 2, 0], [3, 1, 2]], np.int32)
    boxes[cls == 0] = 0.0
    return x, boxes, cls


def jax_noise(rng, cfg, hw):
    """The target noise and dropout keep masks compute_losses draws from
    ``rng``, in its order of splits."""
    a = hw[0] * hw[1] * 9
    rng_rpn, rng_det = jax.random.split(rng)
    rng_det, rng_dropout = jax.random.split(rng_det)

    def draws(keys, n):
        pairs = [jax.random.split(k) for k in keys]
        return tuple(torch.from_numpy(np.stack([np.asarray(jax.random.uniform(pr[i], (n,)))
                                                for pr in pairs])) for i in range(2))

    # the dropout masks: run the head alone on its own path with the same
    # key, every pre-dropout activation 1 (zero kernels, unit biases), so
    # that a kept entry reads 2 and a dropped one 0. JAX maps the head over
    # the batch with one key, so every image gets the same masks.
    t = cfg.train_rois_per_image
    model = jfr.FasterRCNN(config=cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    head = jax.tree.map(lambda s: jnp.zeros(s.shape), shapes["params"]["fastrcnn"])
    for fc in ("fc1", "fc2"):
        head[fc]["bias"] = jnp.ones_like(head[fc]["bias"])
    _, inter = model.apply(
        {"params": {"fastrcnn": head}}, jnp.zeros((hw[0], hw[1], 512)), jnp.zeros((t, 4)),
        method=lambda m, f, r: m.head(f, r, cfg.image_shape, deterministic=False),
        rngs={"dropout": rng_dropout}, capture_intermediates=True)
    masks = tuple(torch.from_numpy(np.asarray(
        inter["intermediates"]["fastrcnn"][f"Dropout_{i}"]["__call__"][0]) != 0).expand(B, t, -1)
        for i in range(2))
    return tft.FasterRCNNNoise(rpn=draws(jax.random.split(rng_rpn, B), a),
                               detection=draws(jax.random.split(rng_det, B),
                                               cfg.post_nms_top_n_train),
                               dropout=masks)


class _FlaxState(NamedTuple):  # the fields train_state_from_flax reads
    params: dict
    batch_stats: dict
    opt_state: tuple
    step: object


def port_state(jstate):
    """JAX's TrainState → the port's: params, momentum trace and step."""
    s = train_state_from_flax(jax.tree.map(
        np.asarray, _FlaxState(jstate.params, {}, jstate.opt_state, jstate.step)))
    return tft.TrainState(s.params, s.opt_state, s.step)


@pytest.fixture(scope="module")
def runs():
    """Two steps on each side. Each port step starts from JAX's state before
    it (step 1 on JAX's momentum trace): two chains run apart would differ
    in the last bit after one step, and VGG's max pools over unnormalized
    activations turn such bits into windows whose maximum moves (measured:
    losses 1e-4 and lower gradients 1.4% apart at the second step)."""
    jcfg, tcfg = JConfig(**TRAIN), TConfig(**TRAIN)
    sd = init_faster_rcnn_params(tcfg, torch.Generator().manual_seed(6), "cpu")
    params = to_flax(sd)["params"]
    tx = jft.make_optimizer(jcfg)
    jstate = jft.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    x, boxes, cls = make_batch()
    jbatch = jft.FasterRCNNBatch(jnp.asarray(x), jnp.asarray(boxes), jnp.asarray(cls))
    tbatch = tft.FasterRCNNBatch(torch.from_numpy(x), torch.from_numpy(boxes),
                                 torch.from_numpy(cls))

    @jax.jit
    def jax_step(state, batch, rng):
        def loss_fn(p):
            parts = jft.compute_losses({"params": p}, batch, jcfg, rng)
            return sum(parts.values()), parts

        (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        new = jft.TrainState(optax.apply_updates(state.params, updates), opt_state,
                             state.step + 1)
        return new, dict(parts, total_loss=loss), grads

    out = []
    for i in range(2):
        rng = jax.random.PRNGKey(200 + i)
        noise = jax_noise(rng, jcfg, tfr.feature_shape(tcfg.image_shape))
        tstate = port_state(jstate)
        jnew, jmetrics, jgrads = jax_step(jstate, jbatch, rng)
        leaves = {k: v.clone().requires_grad_(True) for k, v in tstate.params.items()}
        parts, targets = tft.compute_losses(leaves, tbatch, tcfg, noise, return_targets=True)
        tgrads = dict(zip(leaves, torch.autograd.grad(sum(parts.values()),
                                                      list(leaves.values()))))
        tnew, tmetrics = tft.train_step(tstate, tbatch, None, tcfg, noise)
        out.append(dict(jstate=jnew, jmetrics=jmetrics, jgrads=jgrads, tstate=tnew,
                        tmetrics=tmetrics, tgrads=tgrads, targets=targets))
        jstate = jnew
    return out


@pytest.mark.parametrize("step", [0, 1])
def test_losses_match_jax(runs, step):
    r = runs[step]
    jm = {k: float(v) for k, v in r["jmetrics"].items()}
    tm = {k: float(v) for k, v in r["tmetrics"].items()}
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        assert jm[k] > 0, k
    _, _, det = r["targets"]
    assert int(det.pos_mask.sum()) > 0  # the box loss of the second stage counts


@pytest.mark.parametrize("step", [0, 1])
def test_gradients_match_jax(runs, step):
    r = runs[step]
    jgrads = flax_to_state_dict({"params": jax.tree.map(np.asarray, r["jgrads"])})
    assert set(jgrads) == set(r["tgrads"])
    for name, want in jgrads.items():
        err = float(torch.linalg.vector_norm(r["tgrads"][name] - want))
        assert err <= GRAD_REL * float(torch.linalg.vector_norm(want)) + 1e-9, (name, err)


@pytest.mark.parametrize("step", [0, 1])
def test_updated_params_match_jax(runs, step):
    r = runs[step]
    want = flax_to_state_dict({"params": jax.tree.map(np.asarray, r["jstate"].params)})
    assert r["tstate"].step == int(r["jstate"].step) == step + 1
    for name, w in want.items():
        np.testing.assert_allclose(r["tstate"].params[name].numpy(), w.numpy(), **PARAM_TOL,
                                   err_msg=name)


def test_train_step_entry_point_draws_its_noise():
    cfg = TConfig(**TRAIN)
    state = tft.create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = tft.make_train_step(cfg, device="cpu")
    x, boxes, cls = make_batch()
    batch = tft.FasterRCNNBatch(x, boxes, cls)
    gen = torch.Generator().manual_seed(1)
    noise = tft.draw_noise(cfg, tft.FasterRCNNBatch(torch.from_numpy(x), None, None),
                           torch.Generator().manual_seed(1))
    assert noise.rpn[0].shape == (B, tft.num_anchors(cfg))
    assert noise.detection[0].shape == (B, cfg.post_nms_top_n_train)
    assert noise.dropout[0].shape == (B, cfg.train_rois_per_image, 1024)
    assert noise.dropout[0].dtype == torch.bool
    new, metrics = step(state, batch, gen)
    again, metrics2 = step(state, batch, noise=noise)
    for k in metrics:  # the generator's draw is the noise drawn from the same seed
        assert torch.equal(metrics[k], metrics2[k]), k
    assert new.step == 1 and all(torch.isfinite(v) for v in metrics.values())
    with pytest.raises(ValueError, match="train state must live on"):
        tft.make_train_step(cfg, device="meta")(state, batch)


# ---------------------------------------------------------------- TF goldens


def test_vgg16_matches_the_reference_golden():
    g = ref.load("reference_vgg16.npz")
    w = ref.he_golden_weights(g, seed=1618)
    img = ref._tools("make_vgg_input")()
    state = {}
    for name in {str(n).split("/")[0] for n in g["var_names"]}:
        state[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(w[f"{name}/{name}_W:0"]).transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(w[f"{name}/{name}_b:0"]))
    vgg = tvgg.VGG16()
    vgg.load_state_dict(state)
    feat = vgg(torch.from_numpy(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(feat.detach().numpy(), g["feature_map"], atol=5e-4, rtol=1e-4)


def test_rpn_matches_the_reference_golden():
    # the reference convs have no bias: biases stay zero
    g = ref.load("reference_frcnn_rpn.npz")
    w = ref.golden_weights(g, seed=2222)
    fmap = ref._tools("make_frcnn_rpn_input")()
    rpn = tfr.FasterRCNNRPN()
    oihw = lambda k: torch.from_numpy(np.ascontiguousarray(np.asarray(w[k]).transpose(3, 2, 0, 1)))
    rpn.load_state_dict({
        "rpn_conv.weight": oihw("rpn_conv_w:0"), "rpn_conv.bias": torch.zeros(512),
        "rpn_class.weight": oihw("rpn_cls_w:0"), "rpn_class.bias": torch.zeros(18),
        "rpn_bbox.weight": oihw("rpn_reg_w:0"), "rpn_bbox.bias": torch.zeros(36),
    })
    logits, _, _ = rpn(torch.from_numpy(fmap).permute(0, 3, 1, 2))
    probs = torch.softmax(logits, dim=-1).detach().numpy()
    b, h, w_, k2 = g["probs"].shape
    np.testing.assert_allclose(probs, g["probs"].reshape(b, h, w_, k2 // 2, 2), atol=1e-5)
