"""BENCHMARK.json and the files it names: they load, keep to the contract's
names and limits, and agree with one another; a cell, a configuration and
a per-layer metric come from new files alone."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run

ROOT = Path(run.__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    texts = [w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
    texts += [c["why"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_every_cell_file_agrees_with_benchmark_json():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        cell = run.load_json(ROOT / "perfbench" / "workloads" / f"{w['name']}.json")
        for k in ("config", "traffic", "chips", "why"):
            assert cell[k] == w[k], (w["name"], k)
        mix = run.load_json(ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json")
        assert (ROOT / "perfbench" / "traffic" / f"{mix['kind']}.py").is_file()
        sizes = run.load_json(ROOT / "perfbench" / "configs" / f"{w['config']}.json")
        assert (ROOT / "perfbench" / "configs" / f"{sizes['system']}.py").is_file()
        assert sizes["name"] == w["config"]
        used.add(w["config"])
        assert cell["checks"], "every cell compares something"
        e2e = [m["name"] for m in BENCH["end_to_end"] if run.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in BENCH["per_layer"] if run.applies(m, w["name"])]
        assert layer and all(m["moves"] in e2e for m in layer)
    assert used == set(configs)
    for c in BENCH["configs"]:
        sizes = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("perfbench/configs/")
        assert sizes["reduced"] == c["reduced"] and "assumed" in sizes and sizes["source"]


def test_each_pair_of_config_and_traffic_once_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_declares_what_benchmark_json_says(metric):
    reader = run.load_module(ROOT / "perfbench" / "metrics" / f"{metric['name']}.py")
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        metric["layer"], metric["unit"], metric["source"], metric["moves"])
    assert callable(reader.read)


def test_kernel_rooflines_are_named_as_such():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_new_cell_config_and_metric_from_new_files_alone(tmp_path):
    """In a copy, a new configuration (a file on an existing system), a new
    traffic mix (a file), a new cell on them (a file) and new per-layer
    metrics (readers) are added beside the existing files, BENCHMARK.json
    gains entries, and the harness runs the new cell on the CPU and reports
    the new metrics; no existing file changes."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    before = {p: p.read_bytes() for p in (copy / "perfbench").rglob("*") if p.is_file()}
    cfg = copy / "perfbench" / "configs"
    sizes = json.loads((cfg / "maskrcnn_r101_fpn_1024_bf16.json").read_text())
    sizes.update(name="maskrcnn_r50_fpn_1024", backbone="resnet50")
    (cfg / "maskrcnn_r50_fpn_1024.json").write_text(json.dumps(sizes))
    traffic = copy / "perfbench" / "traffic"
    mix = json.loads((traffic / "offline_b96_masks.json").read_text())
    mix.update(batch=2, masks=False, why="a test")
    (traffic / "offline_b2.json").write_text(json.dumps(mix))
    cell = json.loads((copy / "perfbench/workloads/maskrcnn-bf16-b96.json").read_text())
    cell.update(config="maskrcnn_r50_fpn_1024", traffic="offline_b2",
                why="an R-50 cell added by a test")
    (copy / "perfbench/workloads/maskrcnn-r50-b2.json").write_text(json.dumps(cell))
    (copy / "perfbench/metrics/call_ms.infer.py").write_text(
        'from perfbench.timing import call_ms\n\n'
        'LAYER = "whole call"\nUNIT = "ms"\nSOURCE = "device_trace"\nMOVES = "images_per_s"\n\n'
        'def read(ctx):\n    return call_ms(ctx)\n')
    # a metric that records what the program does in the traced window
    (copy / "perfbench/metrics/calls.infer.py").write_text(
        'import contextlib\n\n'
        'LAYER = "whole call"\nUNIT = "calls"\nSOURCE = "program_counter"\n'
        'MOVES = "images_per_s"\n\n'
        '@contextlib.contextmanager\n'
        'def install(ctx):\n'
        '    call = ctx.system.call\n'
        '    def counted(*args):\n'
        '        ctx.memo["calls"] = ctx.memo.get("calls", 0) + 1\n'
        '        return call(*args)\n'
        '    ctx.system.call = counted\n'
        '    yield\n'
        '    ctx.system.call = call\n\n'
        'def read(ctx):\n    return ctx.memo.get("calls")\n')
    bench["configs"].append({"name": "maskrcnn_r50_fpn_1024", "source": "a test",
                             "file": "perfbench/configs/maskrcnn_r50_fpn_1024.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "maskrcnn-r50-b2", "config": "maskrcnn_r50_fpn_1024",
                               "traffic": "offline_b2", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("maskrcnn-r50-b2")
    for name, unit, source in (("call_ms.infer", "ms", "device_trace"),
                               ("calls.infer", "calls", "program_counter")):
        bench["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                   "source": source, "layer": "whole call",
                                   "moves": "images_per_s", "workloads": ["maskrcnn-r50-b2"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, sys\n"
        "from perfbench import run\n"
        "from perfbench.tests.conftest import TINY_SIZES, TINY_PARAMS\n"
        "assert run.ROOT == __import__('pathlib').Path.cwd().resolve(), run.ROOT\n"
        "line = run.run_cell('maskrcnn-r50-b2', 5, 0.0, True, 'cpu', sizes_override=TINY_SIZES,"
        " params_override=TINY_PARAMS)\n"
        "print(json.dumps({k: v['value'] for k, v in line['metrics'].items()}))\n")
    env_path = f"{copy}:{ROOT}"
    out = subprocess.run([sys.executable, "-c", script], cwd=copy, capture_output=True,
                         text=True, timeout=600,
                         env={**__import__("os").environ, "PYTHONPATH": env_path})
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["call_ms.infer"] > 0
    assert metrics["calls.infer"] == 1  # a window of 0 s holds one batch
    after = {p: p.read_bytes() for p in before}
    assert after == before
