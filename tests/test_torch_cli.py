"""The port's CLI: ``quantize`` → ``serve``, and ``infer``, against JAX.

At the small f32 config (R50, 64², ``detection_min_threshold=0``) on the CPU:

- ``run_quantize`` (the ``quantize`` command's recipe: random pixel-scale
  images, chunks of 1, percentile 90, per-channel) writes an artifact that
  ``serve(quantized=..., device="cpu", block=False)`` answers with exactly
  the detections of the frozen state dict called directly; the same
  artifact without ``quant_meta.json`` serves the same answer through the
  per-channel sniff. The artifact's ``quant_meta.json`` equals JAX's for
  the config.
- ``run_infer`` on a PNG file against JAX's ``cmd_infer`` steps (its ``cv2``
  mold, ``infer_fn``, ``unmold_detections``) on the same pixels and
  converted weights: integer boxes, class ids and valid rows equal, scores
  and soft masks within 1e-4 (the inference parity's tolerance). The
  ``*_det.png`` it writes reads back with ``cv2.imread`` at the input's
  shape.
- ``main``: ``quantize`` keeps JAX's default ``--config shapes`` and
  calibrates on the shapes dataset (``SHAPES_CONFIG`` patched to the small
  config); the artifact serves the frozen state's answer. ``quantize``
  refuses JAX's optimizer flags; ``eval-coco --data-parallel`` launched
  plainly evaluates over a world of one and gives the evaluator the
  single-device rows; ``bench`` hands the rest of its line, leading options
  and ``--help`` included, to ``objectdetection_torch.bench.main`` and
  returns its line, and without a card it is refused as every command is;
  the commands default to the card and raise without one.
- ``run_train`` for 3 steps against JAX's ``cmd_train`` (``SHAPES_CONFIG``
  patched to the small config with ``train_append_gt``, JAX's dataset at
  the config's size, both from the same weights, which the port resumes
  from as its own checkpoint, the port given JAX's per-step noise):
  identical batches, losses within rtol 1e-4, the per-head gradient norms
  within rtol 2e-3 and the final parameters within
  atol 1e-6 + rtol 1e-5, the tolerances of tests/test_torch_train.py.
  Boxes only: with masks, the losses of JAX's jitted train step (value
  and gradient under one jit) and of the same ``compute_losses`` run op by
  op or jitted alone differ in ``mask_loss`` on shapes batches (6.9e-4
  relative on the first one), and the port follows the op-by-op run;
  ``test_masked_step_matches_jax_op_by_op`` (slow: JAX dispatches every op
  of a step on its own, ~2 min) holds that. ``evaluate_on_shapes`` gives JAX's box and
  mask mAP (within 1e-6) on the same weights.
- 2 steps, a checkpoint and ``resume`` to 4 are bit-equal to 4 steps (on
  the CPU: the card's ROIAlign gradient sums with atomics).
- ``demo`` writes PNGs that decode at the image size; ``run_train_coco``
  trains boxes only with JAX's notice when ``--masks`` finds no
  ``pycocotools``, and passes ``--remat`` on as ``remat_backbone``
  (tests/test_torch_remat.py holds what that does).
"""

import json
import shutil
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from objectdetection_tpu import checkpoint as jck
from objectdetection_tpu import detector as jdet
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES
from objectdetection_tpu.data.preprocess import mold_image_host as j_mold
from objectdetection_tpu.data.preprocess import unmold_detections as j_unmold

from objectdetection_torch import checkpoint as tck
from objectdetection_torch import cli, serve
from objectdetection_torch import detector as tdet
from objectdetection_torch import quant as tq
from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.convert import flax_to_state_dict, train_state_from_flax
from objectdetection_torch.data import image_io
from objectdetection_torch.data.preprocess import mold_image_host, unmold_detections
from objectdetection_torch.detector import make_infer_fn
from objectdetection_torch.evaluate import DetectionEvaluator

torch.set_num_threads(1)

NAMES = ["bg", "a", "b", "c"]
SMALL = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
             pre_nms_rois_count=128, post_nms_rois_training=48, post_nms_rois_inference=32,
             train_rois_per_image=8, rpn_train_anchors_per_image=32, max_gt_objects=4,
             compute_dtype="float32", detection_min_threshold=0.0)
JCFG, TCFG = J_SHAPES.replace(**SMALL), T_SHAPES.replace(**SMALL)


def image(seed=5, shape=(48, 80)):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, shape + (3,)).astype(np.float32)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for _ in range(3):
        cy, cx, r = rng.uniform(8, shape[0] - 8), rng.uniform(8, shape[1] - 8), rng.uniform(4, 12)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
    return img.astype(np.uint8)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("int8") / "art")
    qcfg = cli.quantize_config(TCFG)
    frozen = cli.run_quantize(path, qcfg, device="cpu", calib_images=2, batch_size=1,
                              percentile=90.0)
    return path, frozen, qcfg


def served(body, **kw):
    srv = serve.serve(config=TCFG, port=0, block=False, class_names=NAMES, device="cpu", **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/detect",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["detections"]
    finally:
        srv.shutdown()
        srv.server_close()


def direct(params, img, cfg):
    molded, window, _ = mold_image_host(img, cfg)
    det = make_infer_fn(cfg, with_masks=False, device="cpu")(
        params, molded[None], window[None].astype(np.float32))
    rows = torch.cat([det.boxes[0], det.class_ids[0][:, None].float(), det.scores[0][:, None]], 1)
    b, c, s, v = unmold_detections(rows, window.astype(np.float32), cfg.image_shape[:2],
                                   torch.tensor(img.shape[:2]))
    return [{"box_yxyx": [int(x) for x in b[i]], "class_id": int(c[i]),
             "class_name": NAMES[int(c[i])], "score": round(float(s[i]), 4)}
            for i in np.where(v.numpy())[0]]


def test_quantize_then_serve_answers_as_the_frozen_state(artifact, tmp_path):
    path, frozen, qcfg = artifact
    assert all(frozen[k].dtype == torch.int8 for k in frozen if k.endswith("conv1.weight")
               and "branch" in k)
    img = image()
    want = direct(frozen, img, qcfg)
    assert len(want) > 0
    body = image_io.encode_png(img)
    assert served(body, quantized=path) == want
    bare = tmp_path / "no_meta"
    shutil.copytree(path, bare)
    (bare / "quant_meta.json").unlink()
    assert served(body, quantized=str(bare)) == want


def test_quantize_meta_equals_jax(artifact, tmp_path):
    path, _, _ = artifact
    jcfg = JCFG.replace(quantized_inference=True, per_channel_acts=True)
    jck.save_quantized(str(tmp_path / "j"), {"quant": {"s": np.ones(1, np.float32)}}, jcfg)
    with open(f"{path}/quant_meta.json", "rb") as f:
        assert f.read() == (tmp_path / "j" / "quant_meta.json").read_bytes()


def test_infer_matches_jax_steps_and_writes_a_png(tmp_path):
    import cv2  # the test's oracle only

    variables = jax.tree.map(np.asarray, jdet.init_variables(JCFG, jax.random.PRNGKey(42)))
    img = image(seed=8, shape=(56, 72))
    path = tmp_path / "photo.png"
    path.write_bytes(image_io.encode_png(img))
    (res,) = cli.run_infer([str(path)], TCFG, device="cpu", class_names=NAMES,
                           params=flax_to_state_dict(variables))

    rgb = cv2.imread(str(path))[:, :, ::-1]
    molded, window, _ = j_mold(rgb, JCFG)
    det = jdet.make_infer_fn(JCFG, with_masks=True)(
        variables, jnp.asarray(molded[None]), jnp.asarray(window[None].astype(np.float32)))
    boxes, cls, scores, valid = (np.asarray(x) for x in j_unmold(
        jnp.concatenate([det.boxes[0], det.class_ids[0][:, None].astype(jnp.float32),
                         det.scores[0][:, None]], axis=1),
        jnp.asarray(window.astype(np.float32)), JCFG.image_shape[:2], jnp.asarray(rgb.shape[:2])))
    assert valid.sum() > 0
    np.testing.assert_array_equal(res["boxes"], boxes[valid])
    np.testing.assert_array_equal(res["class_ids"], cls[valid])
    np.testing.assert_allclose(res["scores"], scores[valid], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res["masks"], np.asarray(det.masks[0])[valid], rtol=1e-4,
                               atol=1e-4)
    drawn = cv2.imread(res["out"])
    assert drawn is not None and drawn.shape == img.shape
    assert res["out"] == str(tmp_path / "photo_det.png")


def test_main_quantize_shapes_waits_for_a4(tmp_path, monkeypatch, capsys):
    # A4 is ported: the default --config shapes calibrates on shapes images
    import objectdetection_torch.config as tconfig
    from objectdetection_torch.convert import init_params
    from objectdetection_torch.data.shapes import ShapesDataset

    monkeypatch.setattr(tconfig, "SHAPES_CONFIG", TCFG)
    path = str(tmp_path / "q")
    frozen = cli.main(["quantize", "--out", path, "--device", "cpu", "--calib-images", "2",
                       "--batch-size", "1"])
    assert "random images" not in capsys.readouterr().err
    qcfg = cli.quantize_config(TCFG)
    images = ShapesDataset(2, 64, 64, seed=0).load_batch([0, 1], qcfg).images
    want = tq.freeze_weights(tq.calibrate_variables(
        init_params(qcfg, torch.Generator().manual_seed(0), "cpu"), images, qcfg, batch_size=1,
        percentile=90.0, device="cpu"))
    assert frozen.keys() == want.keys() and all(torch.equal(frozen[k], want[k]) for k in want)
    img = image(seed=11, shape=(64, 64))
    answer = direct(frozen, img, qcfg)
    assert served(image_io.encode_png(img), quantized=path) == answer


@pytest.mark.parametrize("flag", ["--train-steps", "--lr", "--lr-schedule"])
def test_main_quantize_refuses_jax_optimizer_flags(tmp_path, flag, capsys):
    # JAX reads them only to rebuild its checkpoint's optimizer state; a
    # port checkpoint carries its own, so the port takes no such flag
    with pytest.raises(SystemExit) as e:
        cli.main(["quantize", "--out", str(tmp_path / "q"), "--config", "coco", flag, "1"])
    assert e.value.code == 2 and flag in capsys.readouterr().err


def test_main_commands_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    path = tmp_path / "x.png"
    path.write_bytes(image_io.encode_png(image()))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["infer", str(path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve", "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["quantize", "--out", str(tmp_path / "q"), "--config", "coco"])
    for argv in (["train"], ["demo"], ["train-coco", "a.json", "imgs"],
                 ["eval-coco", "a.json", "imgs"], ["quantize", "--out", str(tmp_path / "s")]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)


def test_eval_coco_data_parallel_and_bench_are_refused(tmp_path, monkeypatch):
    # bench, like every command, is refused without a card; eval-coco
    # --data-parallel, launched plainly, runs over a world of one and hands
    # the evaluator what the single-device run does
    ann_file, root = tiny_coco(tmp_path)
    rows = []
    add = DetectionEvaluator.add_image

    def record(self, *args, **kwargs):
        rows.append([np.asarray(x) for x in args[:3]])
        return add(self, *args, **kwargs)

    monkeypatch.setattr(DetectionEvaluator, "add_image", record)
    single, _ = cli.run_eval_coco(ann_file, root, config=TCFG, batch=2, device="cpu")
    parallel, _ = cli.run_eval_coco(ann_file, root, config=TCFG, batch=2, data_parallel=True,
                                    device="cpu")
    assert not dist.is_initialized()  # the command ends the process group it started
    assert len(rows) == 4 and sum(len(r[0]) for r in rows) > 0
    for got, want in zip(rows[2:], rows[:2]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert parallel["mAP"] == single["mAP"]
    seen = {}
    monkeypatch.setattr(cli, "run_eval_coco", lambda *a, **kw: seen.update(kw))
    cli.main(["eval-coco", "a.json", "imgs", "--data-parallel", "--device", "cpu"])
    assert seen["data_parallel"] is True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["bench", "--batch", "1"])


def test_bench_hands_the_rest_of_the_line_to_bench_main(monkeypatch):
    from objectdetection_torch import bench

    seen = []
    monkeypatch.setattr(bench, "main", lambda argv=None: seen.append(argv) or {"value": 1.0})
    for argv in (["--batch", "8", "--no-int8", "--device", "cpu"], [], ["--help"],
                 ["--quant-cache", "off", "-h"]):
        assert cli.main(["bench", *argv]) == {"value": 1.0}
        assert seen[-1] == argv


# ---------------------------------------------------------------- training

TRAIN = dict(SMALL, train_append_gt=True)
JTRAIN, TTRAIN = J_SHAPES.replace(**TRAIN), T_SHAPES.replace(**TRAIN)
STEPS, BATCH, POST_NMS = 3, 2, 48
LOSS_RTOL = 1e-4
GRAD_REL = 2e-3  # the per-head gradient norms (tests/test_torch_train.py)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def jax_noise(rng, b, p):
    """The uniform noise JAX's compute_losses draws from ``rng``, in its order."""
    a = JTRAIN.num_anchors()
    rng_rpn, rng_det = jax.random.split(rng)

    def draws(keys, n):
        pairs = [jax.random.split(k) for k in keys]
        return tuple(torch.from_numpy(np.stack([np.asarray(jax.random.uniform(pr[i], (n,)))
                                                for pr in pairs])) for i in range(2))

    return tdet.TrainNoise(rpn=draws(jax.random.split(rng_rpn, b), a),
                           detection=draws(jax.random.split(rng_det, b), p))


def recording(make_step, record, copy):
    def make(*args, **kwargs):
        fn = make_step(*args, **kwargs)

        def step(state, batch, *rest, **kw):
            host = copy(batch)
            new, metrics = fn(state, batch, *rest, **kw)
            record.append((host, {k: float(v) for k, v in metrics.items()}))
            return new, metrics
        return step
    return make


@pytest.fixture(scope="module")
def jax_start():
    variables = jax.tree.map(np.asarray, jdet.init_variables(JTRAIN, jax.random.PRNGKey(3)))
    cfg = cli.train_config(TTRAIN, STEPS, POST_NMS)
    opt = jdet.make_optimizer(JTRAIN.replace(**{k: getattr(cfg, k) for k in (
        "learning_rate", "lr_schedule", "warmup_steps", "total_train_steps")}))
    return jdet.TrainState(variables["params"], variables["batch_stats"],
                           jax.tree.map(np.asarray, opt.init(variables["params"])), np.int32(0))


@pytest.fixture(scope="module")
def train_runs(jax_start, tmp_path_factory):
    from objectdetection_tpu import cli as jcli
    from objectdetection_tpu import config as jconfig
    from objectdetection_tpu.data import shapes as jshapes

    mp = pytest.MonkeyPatch()
    jrec, trec, jsaved = [], [], []
    try:
        mp.setattr(jconfig, "SHAPES_CONFIG", JTRAIN)
        real = jshapes.ShapesDataset
        mp.setattr(jshapes, "ShapesDataset", lambda n, h, w, seed: real(n, 64, 64, seed=seed))
        mp.setattr(jdet, "create_train_state", lambda *a, **k: jax.tree.map(jnp.asarray,
                                                                             jax_start))
        mp.setattr(jdet, "make_train_step", recording(
            jdet.make_train_step, jrec, lambda b: jax.tree.map(np.array, b)))
        mp.setattr(jck, "save_checkpoint",
                   lambda path, state: jsaved.append(jax.tree.map(np.array, state)))
        jcli.main(["train", "--steps", str(STEPS), "--batch", str(BATCH), "--dataset-size", "8",
                   "--post-nms", str(POST_NMS), "--log-every", "1", "--ckpt", "unused"])
        mp.setattr(tdet, "make_train_step", recording(
            tdet.make_train_step, trec, lambda b: [None if x is None else np.array(x)
                                                   for x in b]))
        p = POST_NMS + TTRAIN.max_gt_objects
        start = str(tmp_path_factory.mktemp("jax_start"))
        tck.save_checkpoint(start, train_state_from_flax(jax_start))
        tstate, record = cli.run_train(
            cli.train_config(TTRAIN, STEPS, POST_NMS), steps=STEPS, batch=BATCH,
            dataset_size=8, masks=False, log_every=1, device="cpu",
            noise=lambda step, batch: jax_noise(jax.random.PRNGKey(step), BATCH, p),
            resume=start)
    finally:
        mp.undo()
    return dict(jrec=jrec, trec=trec, jstate=train_state_from_flax(jsaved[0]), tstate=tstate,
                record=record)


def test_run_train_batches_equal_jax(train_runs):
    jrec, trec = train_runs["jrec"], train_runs["trec"]
    assert len(jrec) == len(trec) == STEPS
    for (jb, _), (tb, _) in zip(jrec, trec):
        for got, want in zip(tb, jb):
            np.testing.assert_array_equal(got, want)


def test_run_train_losses_and_weights_match_jax(train_runs):
    for step, ((_, jm), (_, tm)) in enumerate(zip(train_runs["jrec"], train_runs["trec"])):
        assert set(jm) <= set(tm)
        for k, want in jm.items():
            rtol = GRAD_REL if k.startswith("grad_norm/") else LOSS_RTOL
            np.testing.assert_allclose(tm[k], want, rtol=rtol, atol=1e-7,
                                       err_msg=f"step {step} {k}")
        assert jm["mrcnn_box_loss"] > 0
        assert train_runs["record"]["metrics"][step] == tm
    jstate, tstate = train_runs["jstate"], train_runs["tstate"]
    assert tstate.step == jstate.step == STEPS
    for name, want in jstate.params.items():
        np.testing.assert_allclose(tstate.params[name].numpy(), want.numpy(), **PARAM_TOL,
                                   err_msg=name)


@pytest.mark.slow
def test_masked_step_matches_jax_op_by_op(jax_start):
    # the first batch of `train --masks`: the port's losses against JAX's
    # compute_losses run without jit (each op on its own), and beside those
    # of the jitted train step (value and gradient under one jit), which
    # departs from both in mask_loss
    from objectdetection_torch.data.shapes import ShapesDataset

    cfg = cli.train_config(TTRAIN, STEPS, POST_NMS)
    jcfg = JTRAIN.replace(**{k: getattr(cfg, k) for k in (
        "post_nms_rois_training", "post_nms_rois_inference", "pre_nms_rois_count")})
    ids = np.random.RandomState(0).randint(0, 8, BATCH).tolist()
    host = ShapesDataset(8, 64, 64, seed=0).load_batch(ids, cfg, True)
    jbatch = jdet.TrainBatch(*(jnp.asarray(x) for x in host))
    variables = {"params": jax_start.params, "batch_stats": jax_start.batch_stats}
    rng = jax.random.PRNGKey(0)
    with jax.disable_jit():
        eager = jdet.compute_losses(jax.tree.map(jnp.asarray, variables), jbatch, jcfg, rng,
                                    with_masks=True)
    opt = jdet.make_optimizer(jcfg)
    jitted = jdet.make_train_step(jcfg, with_masks=True)(
        jax.tree.map(jnp.asarray, jax_start._replace(opt_state=opt.init(jax_start.params))),
        jbatch, rng)[1]
    tstate = train_state_from_flax(jax_start)
    noise = jax_noise(rng, BATCH, POST_NMS + TTRAIN.max_gt_objects)
    got = tdet.compute_losses({**tstate.params, **tstate.batch_stats},
                              tdet.TrainBatch(*(torch.from_numpy(x) for x in host)), cfg, noise,
                              with_masks=True)
    for k, want in eager.items():
        np.testing.assert_allclose(float(got[k]), float(want), rtol=LOSS_RTOL, err_msg=k)
    print("mask_loss: port", float(got["mask_loss"]), "JAX op by op", float(eager["mask_loss"]),
          "JAX jitted", float(jitted["mask_loss"]))


def test_evaluate_on_shapes_matches_jax(jax_start):
    from objectdetection_tpu import cli as jcli
    from objectdetection_tpu.data.shapes import ShapesDataset as JShapes

    from objectdetection_torch.data.shapes import ShapesDataset

    variables = {"params": jax_start.params, "batch_stats": jax_start.batch_stats}
    params = flax_to_state_dict(variables)
    ids = list(range(10))
    want = jcli.evaluate_on_shapes(jax.tree.map(jnp.asarray, variables), JTRAIN,
                                   JShapes(10, 64, 64, seed=999), ids, score_threshold=0.0,
                                   with_masks=True)
    got = cli.evaluate_on_shapes(params, TTRAIN, ShapesDataset(10, 64, 64, seed=999), ids,
                                 score_threshold=0.0, with_masks=True, device="cpu")
    assert got.keys() == want.keys() == {"mAP", "per_class", "AP50", "mask_mAP"}
    for k in ("mAP", "AP50", "mask_mAP"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["per_class"].keys() == want["per_class"].keys()


def test_resume_continues_bit_equal(tmp_path, capsys):
    cfg = cli.train_config(TTRAIN, 4, POST_NMS)
    run = dict(batch=BATCH, dataset_size=8, masks=False, log_every=10, device="cpu")
    whole, rec_whole = cli.run_train(cfg, steps=4, **run)
    cli.run_train(cfg, steps=2, ckpt=str(tmp_path / "ck"), **run)
    resumed, rec = cli.run_train(cfg, steps=4, resume=str(tmp_path / "ck"), **run)
    assert "resumed from" in capsys.readouterr().out and rec["first_step"] == 2
    assert resumed.step == whole.step == 4 and resumed.opt_state.count == 4
    assert rec["metrics"] == rec_whole["metrics"][2:]
    for part in ("params", "batch_stats"):
        for k, v in getattr(whole, part).items():
            assert torch.equal(getattr(resumed, part)[k], v), k
    for k, v in whole.opt_state.trace.items():
        assert torch.equal(resumed.opt_state.trace[k], v), k


def test_demo_writes_pngs_at_the_image_size(tmp_path):
    res = cli.run_demo(TCFG, num_images=2, seed=1, out_prefix=str(tmp_path / "demo_"),
                       device="cpu")
    assert [r["out"] for r in res] == [str(tmp_path / f"demo_{i}.png") for i in range(2)]
    for r in res:
        with open(r["out"], "rb") as f:
            img = image_io.decode_image(f.read())
        assert img.shape == (64, 64, 3) and img.dtype == np.uint8
        assert len(r["boxes"]) == len(r["scores"]) > 0


def tiny_coco(tmp_path):
    """Two PNG photos with two boxes each (categories 5 and 9) in a COCO
    layout: (annotation file, image directory)."""
    root = tmp_path / "images"
    root.mkdir()
    rng = np.random.RandomState(3)
    images, anns = [], []
    for i, (h, w) in enumerate([(48, 80), (70, 50)]):
        (root / f"{i}.png").write_bytes(image_io.encode_png(image(seed=i, shape=(h, w))))
        images.append(dict(id=i + 1, file_name=f"{i}.png", height=h, width=w))
        for j in range(2):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=[5, 9][j],
                             bbox=[x, y, w / 3, h / 3], iscrowd=0))
    ann_file = tmp_path / "instances.json"
    ann_file.write_text(json.dumps(dict(images=images, annotations=anns, categories=[
        dict(id=5, name="a"), dict(id=9, name="b")])))
    return str(ann_file), str(root)


def test_train_coco_boxes_only_without_pycocotools(tmp_path, capsys, monkeypatch):
    ann_file, root = tiny_coco(tmp_path)
    configs = []
    make_step = tdet.make_train_step
    monkeypatch.setattr(tdet, "make_train_step",
                        lambda cfg, **kw: configs.append(cfg) or make_step(cfg, **kw))
    state, rec = cli.run_train_coco(ann_file, root, base=TTRAIN, steps=2, batch=2,
                                    masks=True, remat=True, log_every=1,
                                    ckpt=str(tmp_path / "ck"), device="cpu")
    assert "pycocotools unavailable — training boxes only" in capsys.readouterr().err
    assert state.step == 2 and len(rec["metrics"]) == 2
    assert all("mask_loss" not in m and np.isfinite(list(m.values())).all()
               for m in rec["metrics"])
    assert state.params["mrcnn.mrcnn_class_logits.weight"].shape[0] == 3  # BG + 2 classes
    assert (tmp_path / "ck" / "train_state.pt").exists()
    assert [c.remat_backbone for c in configs] == [True]  # --remat reaches the step
