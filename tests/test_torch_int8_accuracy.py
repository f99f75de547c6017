"""The int8 accuracy tool (``tools/torch_int8_accuracy.py``) against
``benchmarks/int8_accuracy.py``.

- Its float and int8 configs equal what JAX's script builds from the same
  command line, field by field (JAX's ``main`` is run with its checkpoint,
  evaluation and dataset stubbed, and stopped when it builds the int8
  skeleton).
- End to end on the CPU on a 2-step checkpoint of the port's ``train``
  (``--images 4 --calib-images 4 --per-channel --percentile 90``, with 16
  detection rows in place of SHAPES_CONFIG's 100): the JSON has JAX's
  keys; the float state it evaluates is the checkpoint's, the int8 state it
  evaluates equals ``calibrate_variables`` (chunks of 4) then
  ``freeze_weights`` built here, and its mAP@0.5 numbers (read from its one
  pass over the COCO sweep) equal ``cli.evaluate_on_shapes`` called
  directly on those states at IoU 0.5. A 2-step model detects nothing
  above the score threshold, so the numbers are 0; the states carry the
  comparison.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from objectdetection_torch import checkpoint, cli, detector, quant
from objectdetection_torch import config as tconfig
from objectdetection_torch.config import SHAPES_CONFIG
from objectdetection_torch.convert import init_params
from objectdetection_torch.data.shapes import ShapesDataset

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = load_script("tools/torch_int8_accuracy.py", "torch_int8_accuracy")


class Stop(Exception):
    pass


def jax_configs(argv, monkeypatch):
    """(float config, int8 config) that benchmarks/int8_accuracy.py builds
    from ``argv``."""
    from types import SimpleNamespace

    from objectdetection_tpu import checkpoint as jckpt
    from objectdetection_tpu import cli as jcli
    from objectdetection_tpu import detector as jdet
    from objectdetection_tpu.data import shapes as jshapes

    seen = {}

    def create_train_state(cfg, key):
        seen["float"] = cfg
        return SimpleNamespace(step=0, params={}, batch_stats={})

    def init_variables(cfg, key):
        seen["int8"] = cfg
        raise Stop

    monkeypatch.setattr(jdet, "create_train_state", create_train_state)
    monkeypatch.setattr(jdet, "init_variables", init_variables)
    monkeypatch.setattr(jckpt, "load_checkpoint", lambda path, state: state)
    monkeypatch.setattr(jcli, "evaluate_on_shapes", lambda *a, **k: {"mAP": 0.0, "mask_mAP": 0.0})
    monkeypatch.setattr(jshapes, "ShapesDataset", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["int8_accuracy.py", *argv])
    script = load_script("benchmarks/int8_accuracy.py", "jax_int8_accuracy")
    with pytest.raises(Stop):
        script.main()
    return seen["float"], seen["int8"]


def fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("argv", [
    [],
    ["--per-channel", "--percentile", "90"],
    ["--float-rpn", "--float-box-head", "--float-mask-head", "--float-p2", "--int8-stem",
     "--bf16-stages", "2,3", "--no-int8-pooled", "--no-int8-align-inputs", "--approx-topk",
     "--train-steps", "20", "--lr", "0.01", "--lr-schedule", "constant", "--post-nms", "64"],
], ids=["defaults", "per_channel", "every_flag"])
def test_configs_equal_jax(argv, monkeypatch):
    jfloat, jint8 = jax_configs(["--ckpt", "unused", *argv], monkeypatch)
    args = TOOL.build_parser().parse_args(["--ckpt", "unused", *argv])
    cfg = TOOL.float_config(args)
    assert fields(cfg) == fields(jfloat)
    assert fields(TOOL.int8_config(cfg, args)) == fields(jint8)


def test_every_jax_flag_is_taken():
    jax_parser_flags = {
        "--ckpt", "--images", "--calib-images", "--seed", "--score-threshold", "--percentile",
        "--per-channel", "--float-rpn", "--float-box-head", "--float-mask-head", "--float-p2",
        "--bias-corr", "--int8-stem", "--bf16-stages", "--no-int8-pooled",
        "--no-int8-align-inputs", "--approx-topk", "--train-steps", "--lr", "--lr-schedule",
        "--post-nms"}
    source = (ROOT / "benchmarks" / "int8_accuracy.py").read_text()
    assert all(f'"{flag}"' in source for flag in jax_parser_flags)
    ours = {s for a in TOOL.build_parser()._actions for s in a.option_strings}
    assert ours - {"-h", "--help"} == jax_parser_flags | {"--device"}


@pytest.fixture(scope="module")
def two_step_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "shapes")
    cfg = cli.train_config(SHAPES_CONFIG, 3000, 256, 0.003, "warmup_cosine")
    cli.run_train(cfg, steps=2, batch=1, dataset_size=8, masks=True, ckpt=path, device="cpu")
    return path


def test_tool_end_to_end_equals_direct_evaluation(two_step_ckpt, monkeypatch, capsys):
    # 16 detection rows, as tests/test_torch_bench.py cuts them: the int8
    # mask head runs on every row, in exact f32 products on the CPU
    monkeypatch.setattr(tconfig, "SHAPES_CONFIG",
                        SHAPES_CONFIG.replace(detection_post_nms_instances=16))
    evaluated = []
    real = cli.evaluate_on_shapes

    def spy(params, cfg, *a, **k):
        out = real(params, cfg, *a, **k)
        evaluated.append((params, cfg, k["iou_thresholds"], out))
        return out

    monkeypatch.setattr(cli, "evaluate_on_shapes", spy)
    argv = ["--ckpt", two_step_ckpt, "--images", "4", "--calib-images", "4", "--per-channel",
            "--percentile", "90", "--device", "cpu"]
    out = TOOL.main(argv)
    monkeypatch.setattr(cli, "evaluate_on_shapes", real)
    assert "restored step 2" in capsys.readouterr().err
    assert set(out) == {"float", "int8", "delta"} and set(out["delta"]) == {"box", "mask"}
    for side in ("float", "int8"):
        assert set(out[side]) == {"box_mAP@0.5", "mask_mAP@0.5", "box_mAP@[.5:.95]",
                                  "mask_mAP@[.5:.95]"}
    assert out["delta"]["box"] == out["int8"]["box_mAP@0.5"] - out["float"]["box_mAP@0.5"]
    assert [len(e[2]) for e in evaluated] == [10, 10]  # one pass a state, the COCO sweep

    args = TOOL.build_parser().parse_args(argv)
    cfg = TOOL.float_config(args)
    cfg_q = TOOL.int8_config(cfg, args)
    # the state it loaded: the checkpoint's
    like = detector.create_train_state(cfg, device="cpu")
    state = checkpoint.load_checkpoint(two_step_ckpt, like)
    loaded = {**state.params, **state.batch_stats}
    # the state it froze: calibrated here in chunks of 4 at percentile 90
    images = ShapesDataset(4, 128, 128, seed=args.seed + 2000).load_batch(
        [0, 1, 2, 3], cfg_q).images
    start = {**init_params(cfg_q, torch.Generator().manual_seed(0), device="cpu"), **loaded}
    frozen = quant.freeze_weights(quant.calibrate_variables(start, images, cfg_q, batch_size=4,
                                                            percentile=90.0, device="cpu"))
    for (params, used_cfg, _, _), want, want_cfg in ((evaluated[0], loaded, cfg),
                                                     (evaluated[1], frozen, cfg_q)):
        assert used_cfg == want_cfg
        assert params.keys() == want.keys()
        assert all(torch.equal(params[k], want[k]) for k in want)

    for side, (_, _, _, res) in zip(("float", "int8"), evaluated):
        assert out[side] == {"box_mAP@0.5": res["AP50"], "mask_mAP@0.5": res["mask_AP50"],
                             "box_mAP@[.5:.95]": res["mAP"], "mask_mAP@[.5:.95]": res["mask_mAP"]}
    assert np.isfinite([v for side in ("float", "int8") for v in out[side].values()]).all()


def test_one_pass_over_the_sweep_gives_the_map_at_one_iou(monkeypatch):
    # evaluate_on_shapes over the COCO sweep: its AP50 and mask_AP50 equal
    # the box and mask mAP of the call at IoU 0.5 (the tool reads them so),
    # on detections made from the ground truth (jittered boxes, some wrong
    # classes, masks from the GT masks with noise), so that neither is 0
    from objectdetection_torch.evaluate import coco_iou_thresholds

    cfg = SHAPES_CONFIG.replace(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64)
    ds = ShapesDataset(10, 64, 64, seed=3)
    calls = iter(range(100))

    def fake_make_infer_fn(config, with_masks=True, device="cuda"):
        def infer(params, images, windows):
            i = next(calls) % 2
            ids = list(range(10))[8 * i:8 * i + 8]
            batch = ds.load_batch(ids, cfg, with_masks=True)
            rng = np.random.RandomState(i)
            b, g = batch.gt_class_ids.shape
            n = cfg.detection_post_nms_instances
            boxes = np.zeros((b, n, 4), np.float32)
            cls = np.zeros((b, n), np.int32)
            scores = np.zeros((b, n), np.float32)
            masks = np.zeros((b, n, 28, 28), np.float32)
            boxes[:, :g] = batch.gt_boxes + rng.normal(0, 0.03, (b, g, 4))
            wrong = (np.arange(b)[:, None] + np.arange(g)) % 4 == 1
            cls[:, :g] = np.where(wrong, 1 + batch.gt_class_ids % 3,
                                  batch.gt_class_ids) * (batch.gt_class_ids > 0)
            scores[:, :g] = rng.uniform(0.5, 1.0, (b, g)) * (batch.gt_class_ids > 0)
            for bi in range(b):
                for gi in range(g):
                    y1, x1, y2, x2 = (batch.gt_boxes[bi, gi] * 63).astype(int)
                    if cls[bi, gi] and y2 > y1 and x2 > x1:
                        crop = batch.gt_masks[bi, gi, y1:y2 + 1, x1:x2 + 1]
                        ys = np.linspace(0, crop.shape[0] - 1, 28).astype(int)
                        xs = np.linspace(0, crop.shape[1] - 1, 28).astype(int)
                        masks[bi, gi] = crop[ys][:, xs] + rng.normal(0, 0.3, (28, 28))
            t = torch.from_numpy
            return detector.Detections(t(boxes), t(cls), t(scores), t(scores > 0), t(masks))
        return infer

    monkeypatch.setattr(detector, "make_infer_fn", fake_make_infer_fn)
    ids = list(range(10))
    at50 = cli.evaluate_on_shapes({}, cfg, ds, ids, with_masks=True, device="cpu")
    sweep = cli.evaluate_on_shapes({}, cfg, ds, ids, with_masks=True, device="cpu",
                                   iou_thresholds=coco_iou_thresholds())
    assert set(at50) == {"mAP", "per_class", "AP50", "mask_mAP"}
    assert set(sweep) == {"mAP", "per_class", "AP50", "mask_mAP", "mask_AP50"}
    assert 0 < at50["mAP"] < 1 and 0 < at50["mask_mAP"] < 1
    assert sweep["AP50"] == at50["mAP"] and sweep["mask_AP50"] == at50["mask_mAP"]
    assert sweep["mAP"] < sweep["AP50"] and sweep["mask_mAP"] < sweep["mask_AP50"]
