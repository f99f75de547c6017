"""Slice parity for training: the port's train step against the JAX package's.

The e2e_small config of test_torch_detector.py (R50, 64², f32, masks on,
full-frame masks), with ``train_append_gt`` so that the second stage has
positive ROIs at random weights. The weights are the port's ``init_params``
relaid into the flax tree (the inverse of ``flax_to_state_dict``, built by
running index arrays through it), so JAX never compiles its initializer. The
JAX TrainState goes into the port through ``train_state_from_flax``; both
then take two steps on the same numpy-seeded batch with the same target
noise: JAX draws it from its keys, the test rebuilds it in the order
``compute_losses`` splits them and hands it to the port. The second step
runs on the first step's momentum trace.

Tolerances, stated:
- the discrete targets (RPN anchor classes, the sampled ROIs' validity and
  positivity, their class ids) are equal; sampled ROI coordinates within
  1e-6 (XLA on the CPU contracts the proposal decode into FMAs);
- losses within rtol 1e-4 (f32 throughout, as the inference parity);
- every gradient leaf within 2e-3 of its L2 norm, in L2 (the two frameworks
  sum ~60 convolutions' backward passes in different orders, ~1e-6 relative
  per operation, and mask-loss gradients pass through sigmoids near 0.5);
- updated parameters within atol 1e-6 + rtol 1e-5 (an update is lr = 1e-3
  times a clipped gradient).

The optimizer alone (clip, decay, momentum, heads masking, warmup_cosine) is
held against optax on small trees at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from objectdetection_tpu import detector as jdet
from objectdetection_tpu import losses as jlosses
from objectdetection_tpu.anchors import config_anchors as j_config_anchors
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES
from objectdetection_tpu.layers.proposals import proposal_layer as j_proposal_layer
from objectdetection_tpu.layers.targets import detection_targets as j_detection_targets
from objectdetection_tpu.layers.targets import rpn_targets as j_rpn_targets

from objectdetection_torch import detector as tdet
from objectdetection_torch import optim
from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.convert import (
    flax_to_state_dict, init_params, split_collections, train_state_from_flax,
)

torch.set_num_threads(1)

SMALL = dict(
    image_shape=(64, 64, 3),
    image_min_dim=64,
    image_max_dim=64,
    pre_nms_rois_count=128,
    post_nms_rois_training=48,
    post_nms_rois_inference=32,
    train_rois_per_image=8,
    rpn_train_anchors_per_image=32,
    max_gt_objects=4,
    compute_dtype="float32",
    train_append_gt=True,
)
JCFG = J_SHAPES.replace(**SMALL)
TCFG = T_SHAPES.replace(**SMALL)
B, G = 2, 4
LOSS_RTOL = 1e-4
GRAD_REL = 2e-3
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def to_flax(state_dict, shapes):
    """Port state dict → flax variable tree shaped like ``shapes``: each leaf
    of flax flat indices goes through flax_to_state_dict, which says where
    every flax element lands in the port's layout."""
    index = jax.tree.map(
        lambda s: np.arange(int(np.prod(s.shape)), dtype=np.float32).reshape(s.shape), shapes)
    where = flax_to_state_dict(index)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, s in leaves:
        keys = [k.key for k in path[1:]]
        name = ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel" else keys[-1]])
        flat = np.empty(int(np.prod(s.shape)), np.float32)
        flat[where[name].numpy().astype(np.int64).ravel()] = state_dict[name].numpy().ravel()
        out.append(flat.reshape(s.shape))
    return jax.tree_util.tree_unflatten(treedef, out)


def make_batch(seed=7):
    rng = np.random.RandomState(seed)
    images = rng.uniform(-60.0, 60.0, (B, 64, 64, 3)).astype(np.float32)
    y1x1 = rng.uniform(0.0, 0.55, (B, G, 2))
    hw = rng.uniform(0.2, 0.45, (B, G, 2))
    boxes = np.concatenate([y1x1, np.minimum(y1x1 + hw, 1.0)], -1).astype(np.float32)
    cls = np.array([[1, 3, 2, 0], [2, 1, 0, 0]], np.int32)
    boxes[cls == 0] = 0.0
    masks = np.zeros((B, G, 64, 64), np.float32)
    for i in range(B):
        for j in range(G):
            if cls[i, j]:
                y1, x1, y2, x2 = np.round(boxes[i, j] * 63).astype(int)
                masks[i, j, y1:y2 + 1, x1 + 1:x2] = 1.0  # a rectangle inside its box
    return images, boxes, cls, masks


def jax_noise(rng, p):
    """The uniform noise compute_losses draws from ``rng``, in its order."""
    a = JCFG.num_anchors()
    rng_rpn, rng_det = jax.random.split(rng)

    def draws(keys, n):
        pairs = [jax.random.split(k) for k in keys]
        return tuple(np.stack([np.asarray(jax.random.uniform(pr[i], (n,))) for pr in pairs])
                     for i in range(2))

    return (draws(jax.random.split(rng_rpn, B), a), draws(jax.random.split(rng_det, B), p))


@jax.jit
def jax_step(state, batch, rng):
    """detector.train_step's body, also returning the gradients and targets."""
    tx = jdet.make_optimizer(JCFG)

    def loss_fn(params):
        variables = {"params": params, "batch_stats": state.batch_stats}
        parts = jdet.compute_losses(variables, batch, JCFG, rng, with_masks=True)
        return jlosses.total_loss(parts), parts

    (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    metrics = dict(parts, total_loss=loss)
    new_state = jdet.TrainState(params, state.batch_stats, opt_state, state.step + 1)

    # the targets compute_losses drew, recomputed with the same keys
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    model = jdet.build_model(JCFG)
    anchors = jnp.asarray(j_config_anchors(JCFG))
    _, _, probs, deltas = model.apply(variables, batch.images, method=model.extract)
    rng_rpn, rng_det = jax.random.split(rng)
    rpn = jax.vmap(lambda gb, gv, k: j_rpn_targets(anchors, gb, gv, JCFG, k))(
        batch.gt_boxes, batch.gt_class_ids > 0, jax.random.split(rng_rpn, B))
    props = j_proposal_layer(probs, deltas, anchors, JCFG, training=True)
    gt_rows = jnp.where((batch.gt_class_ids > 0)[..., None], batch.gt_boxes, 0.0)
    props = jnp.concatenate([props, gt_rows], axis=1)
    det = jax.vmap(lambda p, gb, gc, gm, k: j_detection_targets(p, gb, gc, JCFG, k, gt_masks=gm))(
        props, batch.gt_boxes, batch.gt_class_ids, batch.gt_masks, jax.random.split(rng_det, B))
    return new_state, metrics, grads, (rpn.target_class, props, det)


@pytest.fixture(scope="module")
def runs():
    model = jdet.build_model(JCFG)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    params, stats, _ = split_collections(init_params(TCFG, torch.Generator().manual_seed(3), "cpu"))
    variables = to_flax({**params, **stats}, dict(shapes))
    jstate = jdet.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jdet.make_optimizer(JCFG).init(variables["params"]),
        step=jnp.zeros((), jnp.int32))
    tstate = train_state_from_flax(jax.tree.map(np.asarray, jstate))
    images, boxes, cls, masks = make_batch()
    jbatch = jdet.TrainBatch(*(jnp.asarray(x) for x in (images, boxes, cls, masks)))
    tbatch = tdet.TrainBatch(*(torch.from_numpy(x) for x in (images, boxes, cls, masks)))
    out = []
    for i in range(2):
        rng = jax.random.PRNGKey(100 + i)
        p = JCFG.post_nms_rois_training + G
        (rpn_pos, rpn_neg), (det_pos, det_neg) = jax_noise(rng, p)
        noise = tdet.TrainNoise(rpn=(torch.from_numpy(rpn_pos), torch.from_numpy(rpn_neg)),
                                detection=(torch.from_numpy(det_pos), torch.from_numpy(det_neg)))
        jnew, jmetrics, jgrads, jtargets = jax_step(jstate, jbatch, rng)
        leaves = {k: v.clone().requires_grad_(True) for k, v in tstate.params.items()}
        parts, ttargets = tdet.compute_losses({**leaves, **tstate.batch_stats}, tbatch, TCFG,
                                              noise, with_masks=True, return_targets=True)
        tgrads = dict(zip(leaves, torch.autograd.grad(
            sum(parts.values()), list(leaves.values()), allow_unused=True)))
        tnew, tmetrics = tdet.train_step(tstate, tbatch, None, TCFG, with_masks=True,
                                         noise=noise)
        out.append(dict(jstate=jnew, jmetrics=jmetrics, jgrads=jgrads, jtargets=jtargets,
                        tstate=tnew, tmetrics=tmetrics, tgrads=tgrads, ttargets=ttargets))
        jstate, tstate = jnew, tnew
    return out


@pytest.mark.parametrize("step", [0, 1])
def test_targets_match_jax(runs, step):
    r = runs[step]
    j_cls, j_props, j_det = jax.tree.map(np.asarray, r["jtargets"])
    t_rpn, t_props, t_det = r["ttargets"]
    np.testing.assert_array_equal(t_rpn.target_class.numpy(), j_cls)
    np.testing.assert_array_equal((t_props.numpy() != 0).any(-1), (j_props != 0).any(-1))
    np.testing.assert_allclose(t_props.numpy(), j_props, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t_det.valid_mask.numpy(), j_det.valid_mask)
    np.testing.assert_array_equal(t_det.pos_mask.numpy(), j_det.pos_mask)
    np.testing.assert_array_equal(t_det.target_class_ids.numpy(), j_det.target_class_ids)
    np.testing.assert_allclose(t_det.rois.numpy(), j_det.rois, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t_det.target_masks.numpy(), j_det.target_masks)
    assert j_det.pos_mask.sum() > 0  # the second stage and the mask head get a gradient


@pytest.mark.parametrize("step", [0, 1])
def test_losses_match_jax(runs, step):
    r = runs[step]
    jm = {k: float(v) for k, v in r["jmetrics"].items()}
    tm = {k: float(v) for k, v in r["tmetrics"].items() if not k.startswith("grad_norm")}
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        assert jm[k] > 0, k


@pytest.mark.parametrize("step", [0, 1])
def test_gradients_match_jax(runs, step):
    r = runs[step]
    jgrads = flax_to_state_dict({"params": jax.tree.map(np.asarray, r["jgrads"])})
    tgrads = r["tgrads"]
    assert set(jgrads) == set(tgrads)
    for name, want in jgrads.items():
        got = tgrads[name]
        got = torch.zeros_like(want) if got is None else got.detach()
        err = float(torch.linalg.vector_norm(got - want))
        assert err <= GRAD_REL * float(torch.linalg.vector_norm(want)) + 1e-9, (name, err)
    # the metric norms are the per-head norms of these gradients
    for head in ("fpn", "rpn_model", "mrcnn", "mrcnn_mask"):
        norm = optim.global_norm([g for k, g in jgrads.items() if k.startswith(head + ".")])
        np.testing.assert_allclose(float(r["tmetrics"][f"grad_norm/{head}"]), float(norm),
                                   rtol=GRAD_REL)
        assert float(norm) > 0, head


@pytest.mark.parametrize("step", [0, 1])
def test_updated_state_matches_jax(runs, step):
    r = runs[step]
    jstate = train_state_from_flax(jax.tree.map(np.asarray, r["jstate"]))
    tstate = r["tstate"]
    assert tstate.step == jstate.step == step + 1
    for name, want in jstate.params.items():
        np.testing.assert_allclose(tstate.params[name].numpy(), want.numpy(), **PARAM_TOL,
                                   err_msg=name)
    assert set(tstate.opt_state.trace) == set(jstate.opt_state.trace)
    for name, want in jstate.opt_state.trace.items():
        got = tstate.opt_state.trace[name]
        err = float(torch.linalg.vector_norm(got - want))
        assert err <= GRAD_REL * float(torch.linalg.vector_norm(want)) + 1e-9, name
    for name, want in jstate.batch_stats.items():
        assert torch.equal(tstate.batch_stats[name], want)


# ---------------------------------------------------------------- ROIAlign gradient


def _pyramid_case(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(2, s, s, 8).astype(dtype) for s in (32, 16, 8, 4)]
    y1x1 = rng.uniform(0.0, 0.8, (2, 40, 2))
    boxes = np.concatenate([y1x1, np.minimum(y1x1 + rng.uniform(0, 0.9, (2, 40, 2)), 1)],
                           -1).astype(np.float32)
    boxes[:, :4] = 0.0
    grad_out = rng.randn(2, 40, 7, 7, 8).astype(np.float32)
    return feats, boxes, grad_out


def test_roi_align_gradient_matches_jax_autodiff():
    # B1': the JAX package differentiates its four-gather ROIAlign with XLA;
    # the port's plain backward (the card kernel's reference) must agree
    from objectdetection_tpu.ops.roi_align import batched_multilevel_roi_align as j_align

    from objectdetection_torch.ops import roi_align

    feats, boxes, grad_out = _pyramid_case(0)
    _, vjp = jax.vjp(lambda *f: j_align(list(f), jnp.asarray(boxes), (128, 128), (7, 7)),
                     *[jnp.asarray(f) for f in feats])
    want = vjp(jnp.asarray(grad_out))
    got = roi_align.roi_align_backward_plain(torch.from_numpy(grad_out), torch.from_numpy(boxes),
                                             [f.shape for f in feats], (128, 128))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    # through the wrapper: the output carries the gradient to the features,
    # never to the boxes
    tf = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    tb = torch.from_numpy(boxes).requires_grad_(True)
    out = roi_align.batched_multilevel_roi_align(tf, tb, (128, 128), (7, 7))
    out.backward(torch.from_numpy(grad_out))
    assert tb.grad is None
    for f, w in zip(tf, want):
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_roi_align_backward_tolerance_covers_the_plain_bf16_backward():
    # the stated bound of |kernel - plain| must at least hold the plain bf16
    # backward's own distance from the exact (f64) sum
    from objectdetection_torch.ops import roi_align

    _, boxes, grad_out = _pyramid_case(1)
    shapes = [(2, s, s, 8) for s in (32, 16, 8, 4)]
    g16 = torch.from_numpy(grad_out).to(torch.bfloat16)
    b = torch.from_numpy(boxes)
    plain = roi_align.roi_align_backward_plain(g16, b, shapes, (128, 128))
    exact = roi_align.roi_align_backward_plain(g16.double(), b, shapes, (128, 128))
    tol = roi_align.backward_tolerance(g16, b, shapes, (128, 128))
    s_abs = roi_align.roi_align_backward_plain(g16.double().abs(), b, shapes, (128, 128))
    for p, e, t, s_ in zip(plain, exact, tol, s_abs):
        assert bool(((p.double() - e).abs() <= t).all())
        # no blanket bound: a typical element may move by a few bf16 roundings
        if bool((s_ > 0).any()):
            assert float((t[s_ > 0] / s_[s_ > 0]).median()) < 0.1


# ---------------------------------------------------------------- optimizer

OPT_TREE = {
    "fpn": {
        "resnet": {"res2a": {"res2a_branch2a": {"kernel": (1, 1, 3, 4), "bias": (4,)},
                             "bn2a_branch2a": {"scale": (4,), "bias": (4,)}}},
        "fpn_c5p5": {"kernel": (1, 1, 4, 4), "bias": (4,)},
    },
    "rpn_model": {"rpn_conv_shared": {"kernel": (3, 3, 4, 5), "bias": (5,)}},
    "mrcnn": {"mrcnn_class_conv1": {"kernel": (6, 3)}, "mrcnn_class_bn1": {"scale": (3,)}},
    "mrcnn_mask": {"mrcnn_mask_deconv": {"kernel": (2, 2, 4, 4), "bias": (4,)}},
}


def _tree(rng, scale):
    return jax.tree.map(lambda s: (scale * rng.randn(*s)).astype(np.float32), OPT_TREE,
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("train_layers", ["all", "heads"])
@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
@pytest.mark.parametrize("grad_scale", [0.1, 10.0])  # below and above the clip norm
def test_optimizer_matches_optax(train_layers, schedule, grad_scale):
    cfg = JCFG.replace(lr_schedule=schedule, warmup_steps=2, total_train_steps=6,
                       learning_rate=0.05)
    rng = np.random.RandomState(0)
    params = _tree(rng, 1.0)
    tx = jdet.make_optimizer(cfg, train_layers)
    jopt = tx.init(jax.tree.map(jnp.asarray, params))
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = flax_to_state_dict({"params": params})
    topt = optim.init(tparams, train_layers)
    for _ in range(4):
        grads = _tree(rng, grad_scale)
        updates, jopt = tx.update(jax.tree.map(jnp.asarray, grads), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tupd, topt = optim.update(flax_to_state_dict({"params": grads}), topt, tparams,
                                  TCFG.replace(lr_schedule=schedule, warmup_steps=2,
                                               total_train_steps=6, learning_rate=0.05),
                                  train_layers)
        tparams = optim.apply_updates(tparams, tupd)
        want = flax_to_state_dict({"params": jax.tree.map(np.asarray, jparams)})
        for name, w in want.items():
            np.testing.assert_allclose(tparams[name].numpy(), w.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=name)
    frozen = [k for k in tparams if not optim.trained(k, train_layers)]
    assert (train_layers == "heads") == bool(frozen)
    assert not set(frozen) & set(topt.trace)
    # optax's state (masked trees in heads mode, the schedule's count) crosses over
    crossed = train_state_from_flax(jdet.TrainState(
        params=jax.tree.map(np.asarray, jparams), batch_stats={},
        opt_state=jax.tree.map(np.asarray, jopt), step=np.int32(4)), train_layers)
    assert crossed.opt_state.count == topt.count == 4 and crossed.step == 4
    assert set(crossed.opt_state.trace) == set(topt.trace)
    for name, t in topt.trace.items():
        np.testing.assert_allclose(crossed.opt_state.trace[name].numpy(), t.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_learning_rate_schedule_matches_optax():
    cfg = TCFG.replace(lr_schedule="warmup_cosine", warmup_steps=5, total_train_steps=20,
                       learning_rate=0.02)
    sched = optax.warmup_cosine_decay_schedule(0.0, 0.02, 5, 20)
    for count in range(25):
        np.testing.assert_allclose(optim.learning_rate(cfg, count),
                                   float(sched(jnp.int32(count))), rtol=1e-6, atol=1e-9)
    # warmup >= total: optax's decay_steps floor of warmup + 1
    cfg = cfg.replace(warmup_steps=5, total_train_steps=3)
    sched = optax.warmup_cosine_decay_schedule(0.0, 0.02, 5, 6)
    for count in range(8):
        np.testing.assert_allclose(optim.learning_rate(cfg, count),
                                   float(sched(jnp.int32(count))), rtol=1e-6, atol=1e-9)
    assert optim.learning_rate(TCFG, 7) == TCFG.learning_rate


def test_heads_trains_only_the_heads_layers():
    names = list(init_params(TCFG, device="cpu"))
    trained = {k for k in names if optim.trained(k, "heads")}
    assert any(k.startswith("fpn.fpn_c5p5.") for k in trained)
    assert any(k.startswith("mrcnn_mask.mrcnn_mask.") for k in trained)
    assert not any(k.startswith("fpn.resnet.") for k in trained)
    with pytest.raises(ValueError):
        optim.trained(names[0], "backbone")
