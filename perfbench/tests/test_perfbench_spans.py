"""The readers of the program's own spans and counters (``perfbench/spans.py``
and the eight metrics that install it): a ``--trace 1`` run on the CPU at
the tests' small size reports all eight; a program that records no spans
(no ``metrics.collect``, as before it had one) gets None from every one of
them and still completes its line; the idle inside the call is the window's
idle gaps intersected with the call's host intervals."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import run
from perfbench.tests.conftest import TINY_PARAMS, TINY_SIZES
from perfbench.trace import Interval, Trace

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
SPAN_METRICS = ["backbone_span_ms.infer", "rpn_span_ms.infer", "proposals_span_ms.infer",
                "box_stage_span_ms.infer", "detection_span_ms.infer",
                "mask_stage_span_ms.infer", "call_idle_ms.infer", "mask_rows_used_pct.infer"]


def traced(cell):
    return run.run_cell(cell, 2147483700, 0.0, True, "cpu", sizes_override=TINY_SIZES,
                        params_override=TINY_PARAMS)


def test_the_eight_metrics_are_declared_for_both_cells():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SPAN_METRICS:
        assert declared[name]["workloads"] == ["maskrcnn-int8-b96", "maskrcnn-bf16-b96"]


@pytest.mark.parametrize("cell", ["maskrcnn-bf16-b96", "maskrcnn-int8-b96"])
def test_a_traced_run_reports_all_eight(cell):
    line = traced(cell)
    values = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(SPAN_METRICS) <= set(values), sorted(values)
    for name in SPAN_METRICS[:6]:
        assert values[name] > 0, name  # host ms on the CPU
    assert 0 <= values["mask_rows_used_pct.infer"] <= 100
    assert values["call_idle_ms.infer"] > 0  # no device: the whole call is idle
    assert list(line)[-1] == "checks"


def test_a_program_without_spans_gets_none_and_a_line(monkeypatch):
    from objectdetection_torch import metrics

    monkeypatch.delattr(metrics, "collect")
    line = traced("maskrcnn-bf16-b96")
    assert not set(SPAN_METRICS) & set(line["metrics"])
    assert "device_idle_pct.infer" in line["metrics"]
    assert list(line)[-1] == "checks" and isinstance(line["correct"], bool)
    assert not any(name.startswith("odtorch.") for name, _ in line["breakdown"]["idle_gaps"])


def test_call_idle_is_the_gaps_inside_the_calls():
    reader = run.load_module(run.ROOT / "perfbench" / "metrics" / "call_idle_ms.infer.py")
    device = [Interval("k", 10, 40), Interval("k", 60, 90)]
    host = [Interval("odtorch.infer", 5, 50), Interval("odtorch.infer", 55, 95),
            Interval("aten::copy_", 40, 58)]
    ctx = SimpleNamespace(trace=Trace((0.0, 100.0), device, host), batches=2)
    # idle 0-10, 40-60, 90-100; inside the calls 5-10, 40-50, 55-60, 90-95
    assert reader.read(ctx) == pytest.approx(25 / 1e3 / 2)
    ctx = SimpleNamespace(trace=Trace((0.0, 100.0), device, host[2:]), batches=2)
    assert reader.read(ctx) is None
