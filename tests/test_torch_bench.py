"""The port's ``bench`` (``objectdetection_torch/bench.py``) against the root ``bench.py``.

- Flags → config: for eight command lines the root ``bench.py``'s ``main``
  runs with the JAX package's ``detector.init_variables`` replaced by a
  recorder that stops it (and ``metrics.enable_compilation_cache`` by a
  no-op, so that no XLA cache is switched on); every field of the port's
  ``bench_config`` equals the config JAX's ``main`` built.
- ``--realistic``: ``bench.py``'s own tempering runs on a tree of its
  config's shapes (seeded values handed over by the recorder; the cast
  that follows records the tempered tree and stops); the port's
  ``temper_rpn_deltas`` on ``flax_to_state_dict`` of the same tree gives
  it bit for bit, and changes only the RPN's box-delta kernel.
- The recipe (cast to bf16 → calibrate at percentile 90 over chunks of
  ``max(1, B // 16)`` → freeze) at the int8 config of
  tests/test_torch_detector_int8.py (R50, 64², f32 compute), per tensor and
  per channel, on ``bench.py``'s images: the port's ``serving_state``
  against JAX's ``cast_params_for_inference`` → ``calibrate_variables`` →
  ``freeze_weights``. Scales within that file's tolerances (1e-4 relative;
  per channel also 1e-4 of the tensor's largest); JAX's freeze of the
  port's scales equals the port's frozen state bit for bit (int8 kernels,
  kernel scales, the bf16 weights and statistics).
- The line: ``main`` at R50 64², batch 2, on the CPU (``COCO_CONFIG``'s
  proposal and detection budgets cut to 128 / 32 / 16 in the test, to keep
  it quick) prints exactly one line on stdout, JSON with ``bench.py``'s
  keys, its fixed metric name, ``vs_baseline`` = value / 200 and its
  ``config`` strings, in int8 and in bf16; ``main`` returns it.
- The cache: ``--quant-cache DIR`` saves an artifact; a second run loads it
  and calibrates nothing; an artifact without ``pooled_box_scale`` is
  recalibrated and saved again. ``auto`` keys the port's own artifact
  (``artifacts/torch_quant_*``), never JAX's ``quant_*.ckpt``.
- Without a card and without ``--device cpu`` the command raises.
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu import checkpoint as jck
from objectdetection_tpu import detector as jdet
from objectdetection_tpu import metrics as jmetrics
from objectdetection_tpu import quant as jq

import test_torch_detector_int8 as ti
import test_torch_train as tt
from objectdetection_torch import bench, checkpoint, quant
from objectdetection_torch import config as tconfig
from objectdetection_torch.convert import flax_to_state_dict, init_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
J_INIT = jdet.init_variables  # run_root_bench replaces it while bench.py runs


class Stop(Exception):
    """Ends the root bench.py's main once it has shown what a test needs."""


def root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_root_bench(argv, monkeypatch, variables=None):
    """bench.py's main on ``argv`` up to its init: returns the config it
    built, and with ``variables`` (handed over as its init) the tree its
    cast received."""
    seen = {}

    def init(cfg, key):
        seen["cfg"] = cfg
        if variables is None:
            raise Stop
        return variables

    def cast(tree, dtype=None):
        seen["cast"] = tree
        raise Stop

    monkeypatch.setattr(jdet, "init_variables", init)
    monkeypatch.setattr(jmetrics, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(jck, "cast_params_for_inference", cast)
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    with pytest.raises(Stop):
        root_bench().main()
    return seen


FLAG_SETS = [
    [],
    ["--no-int8"],
    ["--no-per-channel", "--fused-bottleneck"],
    ["--int8-stem", "--int8-align-inputs"],
    ["--approx-topk"],
    ["--realistic"],
    ["--backbone", "resnet50", "--image-size", "64"],
    ["--pallas-align", "off", "--s2d-stage2"],
    ["--no-fused-bottleneck", "--no-int8-align-inputs", "--no-int8-stem", "--no-approx-topk",
     "--no-s2d-stage2", "--pallas-align", "masks"],
]


@pytest.mark.parametrize("argv", FLAG_SETS, ids=lambda a: " ".join(a) or "defaults")
def test_flags_set_the_config_jax_sets(argv, monkeypatch):
    want = dataclasses.asdict(run_root_bench(argv, monkeypatch)["cfg"])
    got = dataclasses.asdict(bench.bench_config(bench.build_parser().parse_args(argv)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == v, (k, got[k], v)


def test_realistic_tempers_the_leaves_jax_tempers(monkeypatch):
    argv = ["--backbone", "resnet50", "--image-size", "64", "--realistic"]
    cfg = run_root_bench(argv, monkeypatch)["cfg"]
    shapes = jax.eval_shape(lambda: J_INIT(cfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(5)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    tempered = run_root_bench(argv, monkeypatch, variables=tree)["cast"]
    want = flax_to_state_dict(jax.tree.map(np.asarray, tempered))
    base = flax_to_state_dict(tree)
    got = bench.temper_rpn_deltas(base)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert [k for k in got if not torch.equal(got[k], base[k])] == [
        "rpn_model.rpn_bbox_pred.weight"]


def bench_images(n, size=64):
    """bench.py's images."""
    rng = np.random.RandomState(0)
    return rng.rand(n, size, size, 3).astype(np.float32) * 255.0 - 128.0


def f32_leaves(tree):
    """A flax tree's leaves as numpy, floating ones widened to f32 exactly
    (numpy holds bf16 only as an extension type)."""
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a), tree)


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_recipe_matches_jax(per_channel):
    jcfg, tcfg = ti.configs(per_channel_acts=per_channel)
    model = jdet.build_model(jcfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    sd = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    variables = tt.to_flax(sd, dict(shapes))
    images = bench_images(4)  # chunks of max(1, 4 // 16) = 1 image: 4 chunks
    jcal = jq.calibrate_variables(jck.cast_params_for_inference(variables), jnp.asarray(images),
                                  jcfg, batch_size=1, percentile=90.0)
    got = bench.serving_state(sd, torch.from_numpy(images), tcfg, "off", CPU)
    want = flax_to_state_dict(f32_leaves(jq.freeze_weights(jcal)))
    assert set(got) == set(want)
    n_scales = 0
    for k, v in want.items():
        if k.rsplit(".", 1)[-1] in quant.ACT_SCALES:
            # every range was recorded (per channel, a channel may be dead)
            assert float(v.abs().max() if per_channel else v.abs().min()) > 0, k
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-4 * float(v.abs().max()) if per_channel else 0,
                                       err_msg=k)
            n_scales += 1
    assert n_scales > 80

    # JAX's freeze of the port's scales: the port's frozen state, bit for bit
    def port_scale(path, leaf):
        name = ".".join(p.key for p in path)
        if name.rsplit(".", 1)[-1] in quant.ACT_SCALES:
            return jnp.asarray(got[name].numpy())
        return leaf

    mixed = {**jcal, "quant": jax.tree_util.tree_map_with_path(port_scale, jcal["quant"])}
    want = flax_to_state_dict(f32_leaves(jq.freeze_weights(mixed)))
    n_int8 = 0
    for k, v in want.items():
        g = got[k]
        assert g.dtype == (torch.int8 if v.dtype == torch.int8
                           else torch.float32 if k.rsplit(".", 1)[-1] in quant.QUANT_LEAVES
                           else torch.bfloat16), (k, g.dtype)
        assert torch.equal(g.to(v.dtype), v), k
        n_int8 += v.dtype == torch.int8
    assert n_int8 == 70


# ---------------------------------------------------------------- the command

ARGV = ["--device", "cpu", "--backbone", "resnet50", "--image-size", "64", "--batch", "2",
        "--iters", "1", "--warmup", "0"]


@pytest.fixture
def small_budgets(monkeypatch):
    monkeypatch.setattr(tconfig, "COCO_CONFIG", tconfig.COCO_CONFIG.replace(
        pre_nms_rois_count=128, post_nms_rois_inference=32, detection_post_nms_instances=16))


@pytest.mark.parametrize("extra, config", [
    (["--quant-cache", "off"], "int8_ptq_pc_b2"),
    (["--no-int8"], "bf16_b2"),
    (["--no-per-channel", "--realistic", "--quant-cache", "off", "--no-masks"],
     "int8_ptq_realistic_b2"),
], ids=["int8", "bf16", "int8_per_tensor_realistic"])
def test_main_prints_one_json_line_last(small_budgets, capsys, extra, config):
    line = bench.main(ARGV + extra)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    assert json.loads(out[-1]) == line
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "config"]
    assert line["metric"] == "maskrcnn_r101_1024_infer_throughput"
    assert line["unit"] == "images/sec/chip"
    assert line["config"] == config
    assert line["value"] > 0
    # vs_baseline is rounded from the unrounded rate, value to 2 decimals:
    # they agree within the two roundings' half-units
    assert abs(line["vs_baseline"] - line["value"] / 200.0) <= 0.0005 + 0.005 / 200.0 + 1e-12


def test_quant_cache_saves_loads_and_recalibrates_a_stale_artifact(small_budgets, tmp_path,
                                                                   capsys, monkeypatch):
    cache = tmp_path / "q"
    argv = ARGV + ["--quant-cache", str(cache)]
    bench.main(argv)
    err = capsys.readouterr().err
    assert "int8 calibration+freeze" in err and f"int8 artifact saved to {cache}" in err
    saved = checkpoint.load_quantized(str(cache))
    assert "pooled_box_scale" in saved and saved["fpn.fpn_p2.weight"].dtype == torch.int8

    calls = []
    real = quant.calibrate_variables
    monkeypatch.setattr(quant, "calibrate_variables",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loaded = {}
    real_load = bench._load_artifact
    monkeypatch.setattr(bench, "_load_artifact",
                        lambda *a: loaded.setdefault("state", real_load(*a)))
    bench.main(argv)
    err = capsys.readouterr().err
    assert f"int8 artifact loaded from {cache}" in err
    assert "int8 calibration+freeze" not in err and not calls
    assert set(loaded["state"]) == set(saved)
    for k, v in saved.items():
        assert torch.equal(loaded["state"][k], v), k

    torch.save({k: v for k, v in saved.items() if k != "pooled_box_scale"},
               cache / "variables.pt")
    loaded.clear()
    bench.main(argv)
    err = capsys.readouterr().err
    assert ("quant cache load failed (stale artifact: no pooled-ROI scales); recalibrating"
            in err)
    assert calls == [1] and f"int8 artifact saved to {cache}" in err
    assert "pooled_box_scale" in checkpoint.load_quantized(str(cache))


def test_auto_cache_is_the_ports_own_artifact():
    p = bench.build_parser()
    for argv, name in (([], "torch_quant_resnet101_1024_pc"),
                       (["--no-per-channel", "--realistic"], "torch_quant_resnet101_1024_rl"),
                       (["--backbone", "resnet50", "--image-size", "512"],
                        "torch_quant_resnet50_512_pc")):
        args = p.parse_args(argv)
        assert bench.quant_cache_path(args, bench.bench_config(args)) == str(
            ROOT / "artifacts" / name)
    args = p.parse_args(["--quant-cache", "/x/y"])
    assert bench.quant_cache_path(args, bench.bench_config(args)) == "/x/y"


def test_without_a_card_the_command_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--batch", "1", "--image-size", "64"])
