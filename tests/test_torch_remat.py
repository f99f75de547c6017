"""``remat_backbone`` in the port: the Mask R-CNN backbone's blocks recomputed in the backward.

At tests/test_torch_train.py's config (R50, 64², f32, masks,
``train_append_gt``), from the port's ``init_params`` (seed 3), on that
file's batch with JAX's target noise for ``PRNGKey(100)``:

- one step with ``remat_backbone=True`` is bit-equal to one step without:
  every loss, every gradient leaf, the metrics, the updated parameters and
  the momentum trace. Frozen BatchNorm and no dropout make the recompute
  repeat the forward's arithmetic. A checkpoint of the block module itself
  (``checkpoint(block, x, use_reentrant=False)``) fails here: the step
  takes its gradients after ``functional_call`` has put the model's meta
  tensors back, and such a recompute reads those.
- in that step every bottleneck block's forward runs twice with remat (the
  forward, and its recompute in the backward) and once without; the stem
  runs once. Inference does not recompute, and RetinaNet, whose JAX model
  does not read the field, builds no remat.
- the step matches JAX's jitted ``train_step`` with ``remat_backbone=True``
  (flax ``nn.remat`` of the block) at tests/test_torch_train.py's
  tolerances: losses within rtol 1e-4, the per-head gradient norms and the
  momentum trace (the clipped, decayed gradient) within 2e-3, the updated
  parameters within atol 1e-6 + rtol 1e-5.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu import detector as jdet

import test_torch_train as tt
from objectdetection_torch import detector as tdet
from objectdetection_torch import optim
from objectdetection_torch.convert import init_params, split_collections, train_state_from_flax
from objectdetection_torch.models import backbone

torch.set_num_threads(1)

JCFG = tt.JCFG.replace(remat_backbone=True)
TCFG = tt.TCFG.replace(remat_backbone=True)
N_BLOCKS = 16  # R50: 3 + 4 + 6 + 3 bottleneck blocks


@pytest.fixture(scope="module")
def start():
    """The port's initial state, its flax tree, the batch and the noise."""
    params, stats, _ = split_collections(init_params(tt.TCFG, torch.Generator().manual_seed(3),
                                                     "cpu"))
    shapes = jax.eval_shape(lambda: jdet.build_model(JCFG).init(jax.random.PRNGKey(0),
                                                                jnp.zeros((1, 64, 64, 3))))
    variables = tt.to_flax({**params, **stats}, dict(shapes))
    rng = jax.random.PRNGKey(100)
    (rpn_pos, rpn_neg), (det_pos, det_neg) = tt.jax_noise(rng, JCFG.post_nms_rois_training + tt.G)
    noise = tdet.TrainNoise(rpn=(torch.from_numpy(rpn_pos), torch.from_numpy(rpn_neg)),
                            detection=(torch.from_numpy(det_pos), torch.from_numpy(det_neg)))
    arrays = tt.make_batch()
    return dict(state=tdet.TrainState(params, stats, optim.init(params), 0),
                variables=variables, rng=rng, noise=noise, arrays=arrays,
                batch=tdet.TrainBatch(*(torch.from_numpy(x) for x in arrays)))


def counting(monkeypatch):
    """Counts each bottleneck block's forward calls by name, and the stem's."""
    calls = collections.Counter()
    block_forward = backbone.BottleneckBlock.forward
    max_pool = backbone.max_pool_same

    def forward(self, x):
        calls[self.names[0]] += 1
        return block_forward(self, x)

    def pool(*args, **kwargs):
        calls["stem"] += 1
        return max_pool(*args, **kwargs)

    monkeypatch.setattr(backbone.BottleneckBlock, "forward", forward)
    monkeypatch.setattr(backbone, "max_pool_same", pool)
    return calls


def port_step(start, cfg):
    """One step of ``cfg``: its losses, gradients, new state and metrics."""
    st, batch = start["state"], start["batch"]
    leaves = {k: v.clone().requires_grad_(True) for k, v in st.params.items()}
    parts = tdet.compute_losses({**leaves, **st.batch_stats}, batch, cfg, start["noise"],
                                with_masks=True)
    grads = dict(zip(leaves, torch.autograd.grad(sum(parts.values()), list(leaves.values()),
                                                 allow_unused=True)))
    new, metrics = tdet.train_step(st, batch, None, cfg, with_masks=True, noise=start["noise"])
    return dict(parts=parts, grads=grads, state=new, metrics=metrics)


@pytest.fixture(scope="module")
def steps(start):
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for remat, cfg in ((False, tt.TCFG), (True, TCFG)):
            calls = counting(mp)
            out[remat] = dict(port_step(start, cfg), calls=dict(calls))
            mp.undo()
        return out
    finally:
        mp.undo()


def test_remat_step_is_bit_equal_to_the_plain_step(steps):
    plain, remat = steps[False], steps[True]
    for k, v in plain["parts"].items():
        assert torch.equal(remat["parts"][k], v), k
    for k, v in plain["grads"].items():
        g = remat["grads"][k]
        assert (g is None) == (v is None), k
        assert v is None or torch.equal(g, v), k
    for k, v in plain["metrics"].items():
        assert torch.equal(remat["metrics"][k], v), k
    a, b = plain["state"], remat["state"]
    assert a.step == b.step == 1
    for k, v in a.params.items():
        assert torch.equal(b.params[k], v), k
    for k, v in a.opt_state.trace.items():
        assert torch.equal(b.opt_state.trace[k], v), k
    assert float(plain["metrics"]["grad_norm/fpn"]) > 0


def test_remat_recomputes_each_block_once_and_not_the_stem(steps):
    plain, remat = steps[False]["calls"], steps[True]["calls"]
    blocks = [k for k in plain if k != "stem"]
    assert len(blocks) == N_BLOCKS
    # compute_losses + autograd.grad, then train_step: two forwards a side
    assert all(plain[k] == 2 for k in blocks) and plain["stem"] == 2
    assert all(remat[k] == 4 for k in blocks) and remat["stem"] == 2


def test_inference_and_retinanet_do_not_recompute(start, monkeypatch):
    from objectdetection_torch.config import SHAPES_CONFIG
    from objectdetection_torch.models.retinanet import RetinaNet

    calls = counting(monkeypatch)
    sd = init_params(TCFG, torch.Generator().manual_seed(3), "cpu")
    images = torch.from_numpy(start["arrays"][0])
    windows = torch.tensor([[0.0, 0.0, 64.0, 64.0]] * tt.B)
    tdet.make_infer_fn(TCFG, device="cpu")(sd, images, windows)
    assert set(calls.values()) == {1} and len(calls) == N_BLOCKS + 1
    with torch.device("meta"):
        net = RetinaNet(SHAPES_CONFIG.replace(remat_backbone=True))
    assert not net.fpn.resnet.remat
    assert tdet.build_model(TCFG).fpn.resnet.remat


def test_remat_step_matches_jax_remat_step(start, steps):
    st = start["state"]
    jstate = jdet.TrainState(
        params=start["variables"]["params"], batch_stats=start["variables"]["batch_stats"],
        opt_state=jdet.make_optimizer(JCFG).init(start["variables"]["params"]),
        step=jnp.zeros((), jnp.int32))
    assert train_state_from_flax(jax.tree.map(np.asarray, jstate)).params.keys() == st.params.keys()
    jbatch = jdet.TrainBatch(*(jnp.asarray(x) for x in start["arrays"]))
    jnew, jmetrics = jax.jit(functools.partial(jdet.train_step, config=JCFG, with_masks=True))(
        jstate, jbatch, start["rng"])
    jnew = train_state_from_flax(jax.tree.map(np.asarray, jnew))
    ours = steps[True]
    for k, v in jmetrics.items():
        rtol = tt.GRAD_REL if k.startswith("grad_norm") else tt.LOSS_RTOL
        np.testing.assert_allclose(float(ours["metrics"][k]), float(v), rtol=rtol, atol=1e-7,
                                   err_msg=k)
    for name, want in jnew.params.items():
        np.testing.assert_allclose(ours["state"].params[name].numpy(), want.numpy(),
                                   **tt.PARAM_TOL, err_msg=name)
    for name, want in jnew.opt_state.trace.items():
        got = ours["state"].opt_state.trace[name]
        err = float(torch.linalg.vector_norm(got - want))
        assert err <= tt.GRAD_REL * float(torch.linalg.vector_norm(want)) + 1e-9, name
