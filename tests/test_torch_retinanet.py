"""The port's RetinaNet against the JAX package.

The config of tests/test_retinanet.py (SHAPES_CONFIG, R50-FPN, 64², 4
classes) in f32. Weights are the port's ``init_retinanet_params`` relaid
into the flax tree; inputs are drawn with numpy from seeds. JAX runs op by
op except for the training step, which it jits.

Tolerances, stated (tests/test_torch_faster_rcnn.py's):
- logits and deltas within rtol/atol 1e-4;
- target labels identical, target deltas within 1e-5;
- focal loss within rtol 1e-5, its gradient within 1e-5 of its L2 norm;
- detections: valid flags and class ids identical, boxes within 1e-3 px
  (normalized by 63), scores within 1e-5;
- training: losses within rtol 1e-4, every gradient leaf within 2e-3 of its
  L2 norm, parameters after each of two steps within rtol 1e-5 / atol 1e-6.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu.anchors import config_anchors as j_config_anchors
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES
from objectdetection_tpu.detector import TrainBatch as JBatch
from objectdetection_tpu.models import retinanet as jrn

from objectdetection_torch.anchors import config_anchors
from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.convert import (
    flax_to_state_dict, init_retinanet_params, train_state_from_flax,
)
from objectdetection_torch.detector import TrainBatch as TBatch
from objectdetection_torch.models import retinanet as trn
from objectdetection_torch.ops import anchor_match

torch.set_num_threads(1)

SMALL = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
             rpn_anchor_scales=(8, 16, 32, 64, 128), max_gt_objects=4,
             compute_dtype="float32")
JCFG, TCFG = J_SHAPES.replace(**SMALL), T_SHAPES.replace(**SMALL)
B = 2
FEAT_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-4
GRAD_REL = 2e-3
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
BOX_TOL = 1e-3 / 63  # 1e-3 px in normalized coordinates at 64²


def to_flax(state_dict):
    """Port state dict → flax variables (convs relaid to HWIO; BatchNorm
    mean/var into batch_stats)."""
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


@pytest.fixture(scope="module")
def weights():
    sd = init_retinanet_params(TCFG, torch.Generator().manual_seed(5), "cpu")
    return sd, to_flax(sd)


def images(seed):
    return np.random.RandomState(seed).uniform(-128.0, 127.0, (B, 64, 64, 3)).astype(np.float32)


def make_gt():
    boxes = np.array([[[0.1, 0.1, 0.45, 0.45], [0.5, 0.5, 0.9, 0.9], [0.3, 0.05, 0.62, 0.4],
                       [0, 0, 0, 0]],
                      [[0.2, 0.3, 0.6, 0.7], [0.05, 0.6, 0.3, 0.95], [0, 0, 0, 0],
                       [0, 0, 0, 0]]], np.float32)
    cls = np.array([[1, 3, 2, 0], [2, 1, 0, 0]], np.int32)
    return boxes, cls


def test_seeded_init_has_the_flax_tree(weights):
    sd, variables = weights
    model = jrn.RetinaNet(config=JCFG)
    want = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(variables) == shapes(dict(want))
    back = flax_to_state_dict(jax.tree.map(np.asarray, variables))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    prior = torch.full_like(sd["class_subnet.out.bias"], -float(np.log(99.0)))
    assert torch.equal(sd["class_subnet.out.bias"], prior)
    assert not sd["box_subnet.out.bias"].any() and not sd["class_subnet.conv0.bias"].any()


@pytest.fixture(scope="module")
def forward(weights):
    sd, variables = weights
    x = images(1)
    want = jrn.RetinaNet(config=JCFG).apply(variables, jnp.asarray(x))
    got = trn.apply(sd, torch.from_numpy(x), TCFG)
    return want, got


def test_forward_matches_jax(forward):
    want, got = forward
    a = config_anchors(TCFG).shape[0]
    for g, w, last in zip(got, want, (TCFG.num_classes - 1, 4)):
        assert g.shape == w.shape == (B, a, last)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **FEAT_TOL)
    p = torch.sigmoid(got[0])
    assert 0.001 < float(p.mean()) < 0.05  # the focal prior


def test_targets_match_jax():
    anchors = config_anchors(TCFG)
    np.testing.assert_array_equal(anchors, j_config_anchors(JCFG))
    boxes, cls = make_gt()
    # image 1: a GT whose best anchor is anchor 0 below IoU 0.5 (shifted half
    # a stride off anchor 0 toward its same-shaped neighbour: a tie that goes
    # to the lower index), then an invalid GT, whose argmax is anchor 0 too.
    # Anchor 0 is forced positive by the valid GT; assigning in GT order
    # would let the invalid GT's False overwrite it.
    a0 = anchors[0]
    twin = next(i for i in range(1, len(anchors))
                if np.allclose(anchors[i, 2:] - anchors[i, :2], a0[2:] - a0[:2])
                and anchors[i, 0] == a0[0])
    boxes[1, 2] = (a0 + anchors[twin]) / 2
    cls[1, 2] = 3
    boxes[1, 3] = [0.4, 0.4, 0.6, 0.6]  # an invalid row that still holds a box
    tb, tc = torch.from_numpy(boxes), torch.from_numpy(cls)
    m = anchor_match.anchor_match_plain(torch.from_numpy(anchors), tb, tc > 0)
    assert int(m.gt_argmax[1, 2]) == 0 and float(m.gt_max[1, 2]) < 0.5
    assert int(m.gt_argmax[1, 3]) == 0 and float(m.anchor_max[1, 0]) < 0.5

    want = jax.vmap(lambda gb, gc: jrn.retinanet_targets(jnp.asarray(anchors), gb, gc, JCFG))(
        jnp.asarray(boxes), jnp.asarray(cls))
    got = trn.retinanet_targets(torch.from_numpy(anchors), tb, tc, TCFG)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas), rtol=0, atol=1e-5)
    assert int(got.labels[1, 0]) == 3  # forced through the scatter-max
    labels = got.labels.numpy()
    assert (labels == -1).any() and (labels == 0).any() and (labels > 0).sum() >= 5
    # an image without a valid GT gets no positive
    empty = trn.retinanet_targets(torch.from_numpy(anchors), tb, torch.zeros_like(tc), TCFG)
    assert int(empty.labels.max()) == 0


def test_focal_loss_matches_jax():
    rng = np.random.RandomState(2)
    logits = (rng.randn(B, 300, 3) * 3).astype(np.float32)
    labels = rng.randint(-1, 4, (B, 300)).astype(np.int32)
    valid = labels >= 0
    labels = np.maximum(labels, 0)
    want, jgrad = jax.value_and_grad(jrn.focal_loss)(jnp.asarray(logits), jnp.asarray(labels),
                                                      jnp.asarray(valid))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = trn.focal_loss(t, torch.from_numpy(labels), torch.from_numpy(valid))
    (grad,) = torch.autograd.grad(got, t)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    err = np.linalg.norm(grad.numpy() - np.asarray(jgrad))
    assert err <= 1e-5 * np.linalg.norm(np.asarray(jgrad))
    # ignored anchors count nowhere
    none = trn.focal_loss(t, torch.from_numpy(labels), torch.zeros(B, 300, dtype=torch.bool))
    assert float(none.detach()) == 0.0


@pytest.mark.parametrize("score_threshold", [0.0, 0.0102])
def test_detections_match_jax(forward, score_threshold):
    # on the same logits and deltas (the forward's), 1000 of 1023 anchors
    _, (logits, deltas) = forward
    lg, dl = logits.detach().numpy(), deltas.detach().numpy()
    want = np.asarray(jrn.retinanet_detections(jnp.asarray(lg), jnp.asarray(dl), JCFG,
                                               score_threshold=score_threshold))
    got = trn.retinanet_detections(torch.from_numpy(lg), torch.from_numpy(dl), TCFG,
                                   score_threshold=score_threshold).numpy()
    assert got.shape == want.shape == (B, TCFG.detection_post_nms_instances, 6)
    np.testing.assert_array_equal(got[..., 5] > 0, want[..., 5] > 0)
    np.testing.assert_array_equal(got[..., 4], want[..., 4])
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(got[..., 5], want[..., 5], rtol=0, atol=1e-5)
    n = int((got[..., 5] > 0).sum())
    assert n > 0


def test_infer_fn_runs_the_forward_and_detections(weights, forward):
    sd, _ = weights
    _, (logits, deltas) = forward
    det = trn.make_infer_fn(TCFG, score_threshold=0.0, device="cpu")(sd, images(1))
    assert torch.equal(det, trn.retinanet_detections(logits.detach(), deltas.detach(), TCFG,
                                                     score_threshold=0.0))
    with pytest.raises(ValueError, match="params must live on"):
        trn.make_infer_fn(TCFG, device="meta")(sd, images(1))


# ---------------------------------------------------------------- training

# JAX's step builds its own constant-rate chain: a warmup schedule in the
# config must change nothing (at count 0 it would give a rate of 0)
TRAIN_CFG = dict(lr_schedule="warmup_cosine", warmup_steps=100)


class _FlaxState(NamedTuple):  # the fields train_state_from_flax reads
    params: dict
    batch_stats: dict
    opt_state: tuple
    step: object


@pytest.fixture(scope="module")
def runs(weights):
    """Two steps on each side; each port step starts from JAX's state before
    it (momentum trace and count included)."""
    jcfg, tcfg = JCFG.replace(**TRAIN_CFG), TCFG.replace(**TRAIN_CFG)
    _, variables = weights
    model = jrn.RetinaNet(config=jcfg)
    step_fn, tx = jrn.make_retinanet_train_step(jcfg)
    boxes, cls = make_gt()
    x = images(3)
    jbatch = JBatch(jnp.asarray(x), jnp.asarray(boxes), jnp.asarray(cls))
    tbatch = TBatch(torch.from_numpy(x), torch.from_numpy(boxes), torch.from_numpy(cls))

    @jax.jit
    def jax_grads(params, batch_stats, batch):
        def loss_fn(p):
            parts = jrn.retinanet_losses({"params": p, "batch_stats": batch_stats}, batch, jcfg,
                                         model)
            return sum(parts.values()), parts

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    params = variables["params"]
    jstate = (params, variables["batch_stats"], tx.init(params), jnp.zeros((), jnp.int32))
    tstep, init_state = trn.make_retinanet_train_step(tcfg, device="cpu")
    out = []
    for i in range(2):
        s = train_state_from_flax(jax.tree.map(np.asarray, _FlaxState(*jstate)))
        tstate = trn.RetinaTrainState(s.params, s.batch_stats, s.opt_state, s.step)
        (_, _), jgrads = jax_grads(jstate[0], jstate[1], jbatch)
        jstate, jmetrics = step_fn(jax.tree.map(jnp.copy, jstate), jbatch, jax.random.PRNGKey(i))
        leaves = {k: v.clone().requires_grad_(True) for k, v in tstate.params.items()}
        parts = trn.retinanet_losses({**leaves, **tstate.batch_stats}, tbatch, tcfg)
        tgrads = dict(zip(leaves, torch.autograd.grad(sum(parts.values()),
                                                      list(leaves.values()), allow_unused=True)))
        tnew, tmetrics = tstep(tstate, tbatch)
        out.append(dict(jstate=jstate, jmetrics=jmetrics, jgrads=jgrads, tstate=tnew,
                        tmetrics=tmetrics, tgrads=tgrads))
    fresh = init_state(init_retinanet_params(tcfg, torch.Generator().manual_seed(5), "cpu"))
    return out, fresh


@pytest.mark.parametrize("step", [0, 1])
def test_losses_match_jax(runs, step):
    r = runs[0][step]
    jm = {k: float(v) for k, v in r["jmetrics"].items()}
    tm = {k: float(v) for k, v in r["tmetrics"].items()}
    assert set(tm) == set(jm) == {"focal_loss", "box_loss", "total_loss"}
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        assert jm[k] > 0, k


@pytest.mark.parametrize("step", [0, 1])
def test_gradients_match_jax(runs, step):
    r = runs[0][step]
    jgrads = flax_to_state_dict({"params": jax.tree.map(np.asarray, r["jgrads"])})
    assert set(jgrads) == set(r["tgrads"])
    for name, want in jgrads.items():
        got = r["tgrads"][name]
        got = torch.zeros_like(want) if got is None else got
        err = float(torch.linalg.vector_norm(got - want))
        assert err <= GRAD_REL * float(torch.linalg.vector_norm(want)) + 1e-9, (name, err)


@pytest.mark.parametrize("step", [0, 1])
def test_updated_state_matches_jax(runs, step):
    r = runs[0][step]
    params, stats, _, count = r["jstate"]
    want = flax_to_state_dict({"params": jax.tree.map(np.asarray, params)})
    assert r["tstate"].count == int(count) == step + 1
    for name, w in want.items():
        np.testing.assert_allclose(r["tstate"].params[name].numpy(), w.numpy(), **PARAM_TOL,
                                   err_msg=name)
    frozen = flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, stats)})
    for name, w in frozen.items():
        assert torch.equal(r["tstate"].batch_stats[name], w), name


def test_init_state_splits_the_collections(runs):
    fresh = runs[1]
    assert fresh.count == 0 and fresh.opt_state.count == 0
    assert all(k.endswith((".mean", ".var")) for k in fresh.batch_stats)
    assert set(fresh.opt_state.trace) == set(fresh.params)
    assert not any(t.any() for t in fresh.opt_state.trace.values())
