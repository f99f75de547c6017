"""``conv_epilogue_fused_pct.infer``: the share of the backbone's float convs
whose epilogue ran as one pass, read from the program's counters. A program
without them (the parent of the pass, or the int8 network, which has no
float conv) leaves the metric out; a traced run on the CPU, where the
epilogue runs as PyTorch's ops, reports 0."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import run, spans
from perfbench.tests.conftest import TINY_PARAMS, TINY_SIZES

NAME = "conv_epilogue_fused_pct.infer"
READER = run.load_module(run.ROOT / "perfbench" / "metrics" / f"{NAME}.py")
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")


def ctx_with(counters):
    rec = SimpleNamespace(spans=[object()], counters=counters)
    rec.resolve = lambda: rec
    return SimpleNamespace(memo={spans.KEY: rec})


@pytest.mark.parametrize("counters,want", [
    ({}, None),  # no counter: the parent, or a program that records none
    ({"conv_epilogue.launches": 5}, None),  # no float conv counted
    ({"backbone.float_convs": 224}, 0.0),  # every epilogue as PyTorch's ops
    ({"backbone.float_convs": 224, "conv_epilogue.launches": 224}, 100.0),
    ({"backbone.float_convs": 224, "conv_epilogue.launches": 56}, 25.0),
])
def test_reads_the_share_of_float_convs(counters, want):
    assert READER.read(ctx_with(counters)) == want


def test_no_recording_gives_none():
    assert READER.read(SimpleNamespace(memo={spans.KEY: None})) is None


def test_declared_for_the_two_bf16_cells():
    declared = {m["name"]: m for m in BENCH["per_layer"]}[NAME]
    assert declared["workloads"] == ["maskrcnn-bf16-b96", "retinanet-bf16-b96"]
    assert BENCH["per_layer"][-1]["name"] == NAME


def test_a_traced_cpu_run_reports_it():
    line = run.run_cell("maskrcnn-bf16-b96", 2147483701, 0.0, True, "cpu",
                        sizes_override=TINY_SIZES, params_override=TINY_PARAMS)
    assert line["metrics"][NAME]["value"] == 0.0  # the CPU's path: no pass
    assert list(line)[-1] == "checks"
