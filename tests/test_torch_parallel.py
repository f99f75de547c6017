"""The port's data and tensor parallelism against the JAX package's.

Two gloo ranks on the CPU, each a subprocess of this test (one launch for
the module, its own timeout), on the small config of
tests/test_torch_detector.py (R50, 64², f32) with the weights of
``init_variables(PRNGKey(42))`` converted by ``flax_to_state_dict``. Each
rank writes what it computed under ``tmp_path``; the test process holds it
against JAX, which has conftest's 8 virtual CPU devices:

- data-parallel inference on a batch of 8 (4 rows a rank) against JAX's
  ``make_parallel_infer_fn`` on ``make_mesh(8)``: floats within rtol/atol
  1e-4 (the inference parity's tolerance), valid rows and class ids equal;
  every rank holds the whole batch, and its own rows equal ``make_infer_fn``
  on those rows alone, exactly;
- two data-parallel steps (masks on, ``train_append_gt``) on tests/
  test_torch_train.py's batch of 2, split 1 + 1, whose images differ in
  positive anchors, positive ROIs and ROIs predicted in an active class
  (the second image's dataset lacks a class): the port's single-device
  steps with losses within ROADMAP §C's 1.1e-6 + 5.6e-5 relative, each
  head's gradient norm and each leaf's momentum trace within 5e-4 of its
  norm (only oneDNN's sums at batch 1 against batch 2 differ; the trace of
  the mask head's first conv, whose gradient cancels most, comes closest)
  and updated parameters within tests/test_torch_train.py's tolerance; the first step against JAX's
  jitted ``train_step`` with the same losses and parameters, gradient norms
  and traces within tests/test_torch_train.py's 2e-3 (the port's own single
  step lies 6.0e-4 from JAX's fully jitted one, ROADMAP §C).
  The per-rank mean (a ``DistributedDataParallel`` loss) lies outside
  those tolerances. The non-neutral anchors are the sampler's budget in
  every image, so the RPN class loss's counts are equal by construction;
- ``replicate_state`` gives rank 1, started from other weights, rank 0's;
- dp × tp = 1 × 2: ``shard_state_tp`` (``min_dim`` 512) splits the leaves
  JAX's rule splits (checked in process against JAX's shardings on
  ``make_dp_tp_mesh(4, 2)``), the box head's first kernel is [512, 12544]
  on each rank, and two steps' ``total_loss`` equal the replicated step's
  within rtol 1e-4 (the bound of tests/test_parallel.py's own TP test);
- mesh and batch layouts, as tests/test_parallel.py checks them;
- slow: dp × tp = 2 × 2 over 4 ranks against JAX's ``make_tp_train_step``
  on ``make_dp_tp_mesh(2, 2)``.
"""

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from objectdetection_tpu import detector as jdet
from objectdetection_tpu import parallel as jpar
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES

from objectdetection_torch import detector as tdet
from objectdetection_torch import parallel
from objectdetection_torch.convert import flax_to_state_dict, train_state_from_flax

import test_torch_train as tt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(tt.SMALL)  # tests/test_torch_detector.py's config, with train_append_gt
INFER = dict(SMALL, detection_min_threshold=0.0)  # detections carry rows
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=5.6e-5, atol=1.1e-6)  # ROADMAP §C, training parity on the CPU
GRAD_REL = tt.GRAD_REL  # gradient norms and traces against JAX
# gradient norms and traces of the port's data-parallel steps against its own
# single-device steps: only oneDNN's sums at batch 1 against batch 2 differ
DP_REL = 5e-4
TP_RTOL = 1e-4
STEPS = 2
GEN_SEED = 5  # of the generator both ranks draw a step's noise from
WORKER_TIMEOUT = 180
ACTIVE = np.array([[1, 1, 1, 1], [1, 1, 1, 0]], np.int32)  # image 1's dataset lacks class 3

WORKER = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(1)
mode, port, out = sys.argv[1], sys.argv[4], sys.argv[5]
rank, world = int(sys.argv[2]), int(sys.argv[3])
from objectdetection_torch import detector, optim, parallel
from objectdetection_torch.config import SHAPES_CONFIG

parallel.initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
inp = torch.load(f"{out}/inputs.pt")
train_cfg = SHAPES_CONFIG.replace(**inp["train"])
batch = detector.TrainBatch(*inp["batch"])
res = {}


def flat(prefix, leaves):
    res.update({f"{prefix}/{k}": v.numpy() for k, v in leaves.items()})


def state0():
    return detector.TrainState(inp["params"], inp["stats"], optim.init(inp["params"]), 0)


def steps(step, state, fed):
    for i in range(len(inp["noise"])):
        state, metrics = step(state, fed, None, detector.TrainNoise(*inp["noise"][i]))
        res.update({f"step{i}/{k}": v.numpy() for k, v in metrics.items()})
        flat(f"step{i}/params", state.params)
        flat(f"step{i}/trace", state.opt_state.trace)
    return state


if mode == "dp":
    mesh = parallel.make_mesh(device="cpu")
    res["mesh_shape"] = np.array(mesh.shape)
    res["mesh_axes"] = np.array(mesh.mesh_dim_names)
    # inference: 4 of the 8 rows on each rank
    infer_cfg = SHAPES_CONFIG.replace(**inp["infer"])
    images, windows = parallel.shard_batch((inp["images"], inp["windows"]), mesh)
    res["shard_images"] = images.numpy()
    try:
        parallel.shard_batch(np.zeros((3, 2)), mesh)
    except ValueError:
        res["odd_batch_refused"] = np.array(True)
    det = parallel.make_parallel_infer_fn(infer_cfg, mesh)(inp["params_all"], images, windows)
    alone = detector.make_infer_fn(infer_cfg, device="cpu")(inp["params_all"], images, windows)
    for k in ("boxes", "class_ids", "scores", "valid", "masks"):
        res[f"det/{k}"] = getattr(det, k).numpy()
        res[f"alone/{k}"] = getattr(alone, k).numpy()
    # training: rank 1 starts from other weights, replicate_state gives it rank 0's
    state = state0()
    if rank == 1:
        state = state._replace(params={k: v + 1 for k, v in state.params.items()})
    state = parallel.replicate_state(state, mesh)
    flat("replicated", state.params)
    shard = parallel.shard_batch(batch, mesh)
    noise = detector.TrainNoise(*inp["noise"][0])
    own = detector.TrainNoise(*(tuple(t[rank:rank + 1] for t in pair) for pair in noise))
    with torch.no_grad():  # this rank's per-rank mean losses and its targets
        parts, (rpn, _, det_t) = detector.compute_losses(
            {**inp["params"], **inp["stats"]}, shard, train_cfg, own, with_masks=True,
            return_targets=True)
    res.update({f"local/{k}": v.numpy() for k, v in parts.items()})
    res["count/pos_anchors"] = np.array(int((rpn.target_class == 1).sum()))
    res["count/non_neutral"] = np.array(int((rpn.target_class != 0).sum()))
    res["count/pos_rois"] = np.array(int(det_t.pos_mask.sum()))
    dp_step = parallel.make_parallel_train_step(train_cfg, mesh, with_masks=True)
    steps(dp_step, state, shard)
    # the noise drawn for the whole batch from a generator seeded alike on every rank
    _, metrics = dp_step(state, shard, torch.Generator().manual_seed(inp["gen_seed"]))
    res.update({f"drawn/{k}": v.numpy() for k, v in metrics.items()})
    # dp x tp = 1 x 2 on the same world
    mesh2 = parallel.make_dp_tp_mesh(1, 2, device="cpu")
    tp_state = parallel.shard_state_tp(state0(), mesh2, min_dim=512)
    split = parallel.tp_split_dims(inp["params"], 2, 512)
    res["tp/split"] = np.array(sorted(split))
    res["tp/conv1_shape"] = np.array(tp_state.params["mrcnn.mrcnn_class_conv1.weight"].shape)
    run = parallel.make_tp_train_step(train_cfg, mesh2, split, with_masks=True)
    for i in range(len(inp["noise"])):
        tp_state, metrics = run(tp_state, batch, None, detector.TrainNoise(*inp["noise"][i]))
        res[f"tp/step{i}/total_loss"] = metrics["total_loss"].numpy()
    flat("tp/params", {k: tp_state.params[k] for k in split})
elif mode == "tp22":
    mesh = parallel.make_dp_tp_mesh(2, 2, device="cpu")
    run = parallel.make_tp_train_step(train_cfg, mesh, parallel.tp_split_dims(inp["params"], 2))
    _, metrics = run(parallel.shard_state_tp(state0(), mesh), batch, None,
                     detector.TrainNoise(*inp["noise"][0]))
    res["total_loss"] = metrics["total_loss"].numpy()
np.savez(f"{out}/{mode}_{rank}.npz", **res)
print(f"rank {rank} ok", flush=True)
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(mode, world, out):
    """Start ``world`` ranks of WORKER; returns a function that waits for them
    and loads what each wrote."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, mode, str(r), str(world),
                               str(port), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=str(out))
             for r in range(world)]

    def wait():
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, text) in enumerate(zip(procs, outs)):
            assert p.returncode == 0 and f"rank {r} ok" in text, f"rank {r}:\n{text}"
        return [dict(np.load(out / f"{mode}_{r}.npz")) for r in range(world)]

    return wait


def images8(seed=123):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-60.0, 60.0, (8, 64, 64, 3)).astype(np.float32)
    yy, xx = np.mgrid[:64, :64]
    for b in range(8):
        for _ in range(3):
            cy, cx, r = rng.uniform(10, 54), rng.uniform(10, 54), rng.uniform(5, 14)
            img[b][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] += rng.uniform(-80, 80, 3)
    return img, np.tile(np.array([[0.0, 0.0, 64.0, 64.0]], np.float32), (8, 1))


def jax_state(variables):
    return jdet.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=jdet.make_optimizer(tt.JCFG).init(variables["params"]),
                           step=jnp.zeros((), jnp.int32))


def torch_noise(rng):
    (rp, rn), (dp, dn) = tt.jax_noise(rng, tt.JCFG.post_nms_rois_training + tt.G)
    return tuple(tuple(torch.from_numpy(x) for x in pair) for pair in ((rp, rn), (dp, dn)))


def make_batch():
    """tests/test_torch_train.py's batch with one GT fewer in image 1, whose
    dataset also lacks class 3: the images differ in positive anchors,
    positive ROIs and ROIs predicted in an active class."""
    images, boxes, cls, masks = tt.make_batch()
    cls[1, 1], boxes[1, 1], masks[1, 1] = 0, 0.0, 0.0
    return images, boxes, cls, masks, ACTIVE


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    variables = jdet.init_variables(tt.JCFG, jax.random.PRNGKey(42))
    np_vars = jax.tree.map(np.asarray, variables)
    tstate = train_state_from_flax(jax.tree.map(np.asarray, jax_state(variables)))
    batch = make_batch()
    tbatch = tdet.TrainBatch(*(torch.from_numpy(x) for x in batch))
    rngs = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]
    noise = [torch_noise(r) for r in rngs]
    img8, win8 = images8()
    torch.save(dict(train=SMALL, infer=INFER, params=tstate.params, stats=tstate.batch_stats,
                    params_all=flax_to_state_dict(np_vars), batch=tuple(tbatch), noise=noise,
                    images=torch.from_numpy(img8), windows=torch.from_numpy(win8),
                    gen_seed=GEN_SEED),
               out / "inputs.pt")
    wait = launch("dp", 2, out)
    try:  # JAX and the single-device port, while the ranks run
        mesh = jpar.make_mesh(8)
        sh = jpar.batch_sharding(mesh)
        jdet_out = jpar.make_parallel_infer_fn(J_SHAPES.replace(**INFER), mesh, with_masks=True)(
            variables, jax.device_put(jnp.asarray(img8), sh),
            jax.device_put(jnp.asarray(win8), sh))
        jstep = jax.jit(functools.partial(jdet.train_step, config=tt.JCFG, with_masks=True))
        jnew, jmetrics = jstep(jax_state(variables),
                               jdet.TrainBatch(*(jnp.asarray(x) for x in batch)), rngs[0])
        single, state = [], tstate
        for i in range(STEPS):
            state, metrics = tdet.train_step(state, tbatch, None, tt.TCFG, with_masks=True,
                                             noise=tdet.TrainNoise(*noise[i]))
            single.append((state, metrics))
        drawn = tdet.train_step(tstate, tbatch, torch.Generator().manual_seed(GEN_SEED), tt.TCFG,
                                with_masks=True)[1]
    finally:
        ranks = wait()
    return dict(ranks=ranks, drawn=drawn, inputs=out / "inputs.pt", tstate=tstate,
                single=single, jdet=jax.tree.map(np.asarray, jdet_out),
                jstate=train_state_from_flax(jax.tree.map(np.asarray, jnew)),
                jmetrics={k: float(v) for k, v in jmetrics.items()}, variables=variables)


# ---------------------------------------------------------------- layouts


@pytest.fixture
def world_of_one():
    mesh = parallel.make_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_make_mesh_spans_the_world(world_of_one):
    assert world_of_one.shape == (1,) and world_of_one.mesh_dim_names == ("data",)
    assert parallel.make_mesh(1, device="cpu").shape == (1,)
    assert parallel.make_mesh(None, ("data", "model"), device="cpu").shape == (1, 1)
    with pytest.raises(ValueError, match="one device each"):
        parallel.make_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="needs 8 processes"):
        parallel.make_dp_tp_mesh(4, 2, device="cpu")


def test_shard_batch_layout(world_of_one, runs):
    img8, _ = images8()
    batch = parallel.shard_batch(tdet.TrainBatch(torch.from_numpy(img8), None, None), world_of_one)
    assert batch.images.shape == (8, 64, 64, 3) and batch.gt_boxes is None
    for r, rank in enumerate(runs["ranks"]):
        assert tuple(rank["mesh_shape"]) == (2,) and tuple(rank["mesh_axes"]) == ("data",)
        np.testing.assert_array_equal(rank["shard_images"], img8[4 * r: 4 * r + 4])
        assert rank["odd_batch_refused"]


# ---------------------------------------------------------------- inference


def test_dp_inference_matches_jax(runs):
    j = runs["jdet"]
    for rank in runs["ranks"]:
        np.testing.assert_array_equal(rank["det/valid"], np.asarray(j.valid))
        np.testing.assert_array_equal(rank["det/class_ids"], np.asarray(j.class_ids))
        for k in ("boxes", "scores", "masks"):
            np.testing.assert_allclose(rank[f"det/{k}"], np.asarray(getattr(j, k)), **TOL,
                                       err_msg=k)
    assert np.asarray(j.valid).sum(axis=1).min() > 0  # every image carries rows


def test_dp_inference_gathers_each_ranks_own_rows(runs):
    r0, r1 = runs["ranks"]
    for k in ("boxes", "class_ids", "scores", "valid", "masks"):
        np.testing.assert_array_equal(r0[f"det/{k}"], r1[f"det/{k}"])
        np.testing.assert_array_equal(
            r0[f"det/{k}"], np.concatenate([r0[f"alone/{k}"], r1[f"alone/{k}"]]), err_msg=k)


# ---------------------------------------------------------------- data-parallel training


def check_step(rank, step, metrics, state, rel):
    """A data-parallel rank's step ``step`` against a single-device one:
    losses within LOSS_TOL, per-head gradient norms and every leaf's
    momentum trace within ``rel`` (of its norm), parameters within
    PARAM_TOL."""
    for k, want in metrics.items():
        got = rank[f"step{step}/{k}"]
        if k.startswith("grad_norm/"):
            np.testing.assert_allclose(got, float(want), rtol=rel, err_msg=k)
        else:
            np.testing.assert_allclose(got, float(want), **LOSS_TOL, err_msg=k)
    for name, want in state.opt_state.trace.items():
        got, want = rank[f"step{step}/trace/{name}"], want.numpy()
        err = float(np.linalg.norm(got - want))
        assert err <= rel * float(np.linalg.norm(want)) + 1e-12, (name, err)
    for name, want in state.params.items():
        np.testing.assert_allclose(rank[f"step{step}/params/{name}"], want.numpy(),
                                   **tt.PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("step", range(STEPS))
def test_dp_step_equals_the_single_device_step(runs, step):
    state, metrics = runs["single"][step]
    for rank in runs["ranks"]:
        check_step(rank, step, metrics, state, DP_REL)


def test_dp_step_draws_the_whole_batchs_noise(runs):
    # each rank draws the global batch's noise from its generator and keeps its
    # rows, so that the targets sample as on one device
    for rank in runs["ranks"]:
        for k, want in runs["drawn"].items():
            tol = dict(rtol=DP_REL) if k.startswith("grad_norm/") else LOSS_TOL
            np.testing.assert_allclose(rank[f"drawn/{k}"], float(want), **tol, err_msg=k)


def test_dp_step_matches_jax(runs):
    for rank in runs["ranks"]:
        check_step(rank, 0, runs["jmetrics"], runs["jstate"], GRAD_REL)


def test_per_rank_mean_is_not_the_global_loss(runs):
    r0, r1 = runs["ranks"]
    # the shards differ in every count but the sampler's fixed budget
    assert r0["count/non_neutral"] == r1["count/non_neutral"]
    assert r0["count/pos_anchors"] != r1["count/pos_anchors"]
    assert r0["count/pos_rois"] != r1["count/pos_rois"]
    want = runs["jmetrics"]
    per_rank = {k: (float(r0[f"local/{k}"]) + float(r1[f"local/{k}"])) / 2
                for k in want if not k.startswith("grad_norm/") and k != "total_loss"}
    per_rank["total_loss"] = sum(per_rank.values())
    for k in ("rpn_box_loss", "mrcnn_class_loss", "mrcnn_box_loss", "mask_loss", "total_loss"):
        assert abs(per_rank[k] - want[k]) > LOSS_TOL["atol"] + LOSS_TOL["rtol"] * abs(want[k]), k


def test_replicate_state_gives_every_rank_rank_0s_weights(runs):
    for rank in runs["ranks"]:
        for name, want in runs["tstate"].params.items():
            np.testing.assert_array_equal(rank[f"replicated/{name}"], want.numpy())


# ---------------------------------------------------------------- tensor parallelism


def jax_split_leaves(dp, tp, min_dim=512):
    """Names (the port's) of the leaves JAX's shard_state_tp does not
    replicate, in params and in the momentum trace."""
    model = jdet.build_model(tt.JCFG)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes["params"])
    state = jdet.TrainState(params, {}, jdet.make_optimizer(tt.JCFG).init(params),
                            jnp.zeros((), jnp.int32))
    placed = jpar.shard_state_tp(state, jpar.make_dp_tp_mesh(dp, tp), min_dim)

    def names(tree):
        split = jax.tree.map(lambda x: np.full(x.shape, not x.sharding.is_fully_replicated), tree)
        return {k for k, v in flax_to_state_dict({"params": split}).items() if v.all()}

    trace = [x for x in jax.tree.leaves(placed.opt_state, is_leaf=lambda x: hasattr(x, "trace"))
             if hasattr(x, "trace")][0].trace
    return names(placed.params), names(trace)


def test_tp_split_leaves_match_jax(runs):
    jparams, jtrace = jax_split_leaves(4, 2)
    ours = set(parallel.tp_split_dims(runs["tstate"].params, 2, 512))
    assert ours == jparams == jtrace
    assert len(ours) == 25 and "mrcnn.mrcnn_class_conv1.weight" in ours
    for rank in runs["ranks"]:
        assert set(rank["tp/split"]) == ours


def test_tp_step_matches_the_replicated_step(runs):
    for rank in runs["ranks"]:
        assert tuple(rank["tp/conv1_shape"]) == (512, 12544)
        for step in range(STEPS):
            np.testing.assert_allclose(rank[f"tp/step{step}/total_loss"],
                                       float(runs["single"][step][1]["total_loss"]), rtol=TP_RTOL)
    # the two slices of each split leaf make the replicated step's weight
    state = runs["single"][-1][0]
    for name in runs["ranks"][0]["tp/split"]:
        d = 1 if name.endswith("mrcnn_mask_deconv.weight") else 0
        whole = np.concatenate([r[f"tp/params/{name}"] for r in runs["ranks"]], axis=d)
        np.testing.assert_allclose(whole, state.params[name].numpy(), **tt.PARAM_TOL,
                                   err_msg=name)


@pytest.mark.slow  # four ranks and JAX's dp×tp program, as tests/test_parallel.py marks its own
def test_dp_tp_2x2_matches_jax(runs, tmp_path):
    import shutil

    shutil.copy(runs["inputs"], tmp_path / "inputs.pt")
    wait = launch("tp22", 4, tmp_path)
    variables = runs["variables"]
    batch = jdet.TrainBatch(*(jnp.asarray(x) for x in make_batch()))
    mesh = jpar.make_dp_tp_mesh(2, 2)
    _, jm = jpar.make_tp_train_step(tt.JCFG, mesh)(
        jpar.shard_state_tp(jax_state(variables), mesh), batch, jax.random.PRNGKey(100))
    for rank in wait():
        np.testing.assert_allclose(rank["total_loss"], float(jm["total_loss"]), rtol=TP_RTOL)
