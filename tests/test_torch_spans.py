"""The port's spans and counters (``metrics.span`` / ``count`` / ``collect``)
inside the inference call, on the CPU.

At the 64² e2e_small budgets of ``tests/test_torch_stage_time.py`` (R50,
batch 2, 16 detection rows, served in bf16 as ``bench`` serves): off (the
default), a call records nothing and never reaches ``record_function``, a
CUDA event or a counter; on, one call gives ``odtorch.infer`` with the six
stage spans as its children in pipeline order, all of one call id, the
outputs bit-equal to a call with collection off; the mask counters equal
the rows the mask stage ran and the detections among them; under
``torch.profiler`` each span is a host event that covers the aten ops of
its stage. Spans nest per thread. On the card (marked ``cuda``; run with
``python -m pytest --noconftest -m cuda tests/test_torch_spans.py``) each span
reads its device extent from a pair of CUDA events, and the stages' extents
lie inside the call's.
"""

import threading

import pytest
import torch

from objectdetection_torch import checkpoint, detector, metrics
from objectdetection_torch import config as tconfig
from objectdetection_torch.convert import init_params

from test_torch_stage_time import E2E_SMALL

torch.set_num_threads(1)

STAGES = ("odtorch.backbone", "odtorch.rpn", "odtorch.proposals", "odtorch.box_stage",
          "odtorch.detection", "odtorch.mask_stage")
CFG = tconfig.SHAPES_CONFIG.replace(**E2E_SMALL)


@pytest.fixture(scope="module")
def served():
    params = checkpoint.cast_params_for_inference(
        init_params(CFG, torch.Generator().manual_seed(0), device="cpu"))
    gen = torch.Generator().manual_seed(1)
    images = torch.rand((2, 64, 64, 3), generator=gen) * 255.0 - 128.0
    windows = torch.tensor([[0.0, 0.0, 64.0, 64.0]]).repeat(2, 1)
    return params, images, windows


def call(served, with_masks=True):
    params, images, windows = served
    return detector.make_infer_fn(CFG, with_masks=with_masks, device="cpu")(
        params, images, windows)


def recorded(served, calls=1, with_masks=True):
    with metrics.collect() as rec:
        outs = [call(served, with_masks) for _ in range(calls)]
    return rec.resolve(), outs


def test_off_records_nothing_and_reaches_no_profiler_event_or_counter(served, monkeypatch):
    with metrics.collect() as rec:
        pass

    def refuse(*a, **k):
        raise AssertionError("reached with collection off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(metrics, "count", refuse)
    assert not metrics.collecting()
    assert metrics.span("odtorch.infer") is metrics.span("odtorch.backbone")
    out = call(served)
    assert out.masks is not None
    assert rec.spans == [] and rec.counters == {}


def test_outputs_bit_equal_with_collection_on_and_off(served):
    off = call(served)
    _, (on,) = recorded(served)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_one_call_nests_the_six_stages_in_pipeline_order(served):
    rec, _ = recorded(served)
    assert [s.name for s in rec.spans] == ["odtorch.infer", *STAGES]
    top, stages = rec.spans[0], rec.spans[1:]
    assert top.parent is None and all(s.parent == 0 for s in stages)
    assert len({s.call for s in rec.spans}) == 1
    t = top.start_ns
    for s in stages:
        assert t <= s.start_ns < s.end_ns <= top.end_ns
        t = s.end_ns
    assert all(s.device_ms > 0 for s in rec.spans)  # host ms on the CPU

    rec, _ = recorded(served, calls=2)
    infers = rec.named("odtorch.infer")
    assert len(infers) == 2 and infers[0].call != infers[1].call
    for s in rec.spans:
        if s.parent is not None:
            assert s.call == rec.spans[s.parent].call


def test_mask_counters_are_rows_and_detections(served):
    rec, (out,) = recorded(served)
    assert rec.counters["mask_stage.rows"] == 2 * CFG.detection_post_nms_instances
    assert rec.counters["mask_stage.valid"] == int((out.scores > 0).sum())
    assert isinstance(rec.counters["mask_stage.valid"], int)

    rec, _ = recorded(served, calls=2)
    assert rec.counters["mask_stage.rows"] == 4 * CFG.detection_post_nms_instances


def test_profiler_host_events_cover_each_stages_ops(served):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        recorded(served)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    by_name = {n: [e for e in events if e.name == n] for n in ("odtorch.infer", *STAGES)}
    assert all(len(v) == 1 for v in by_name.values()), {k: len(v) for k, v in by_name.items()}
    top = by_name["odtorch.infer"][0].time_range
    stages = [by_name[n][0].time_range for n in STAGES]
    t = top.start
    for r in stages:
        assert t <= r.start and r.end <= top.end
        t = r.end
    lo, hi = stages[0].start, stages[-1].end
    ops = [e.time_range for e in events if e.name.startswith("aten::")
           and lo <= e.time_range.start <= hi]
    assert len(ops) > 50
    for op in ops:
        assert any(r.start <= op.start and op.end <= r.end for r in stages), op
    for r in stages:
        assert any(r.start <= op.start and op.end <= r.end for op in ops)


def test_without_masks_no_mask_stage_and_no_mask_counters(served):
    rec, (out,) = recorded(served, with_masks=False)
    assert out.masks is None
    assert [s.name for s in rec.spans] == ["odtorch.infer", *STAGES[:-1]]
    assert rec.counters == {"backbone.float_convs": 61}  # R50's float convs, no mask counter


def test_spans_nest_per_thread():
    go = threading.Barrier(2, timeout=30)

    def worker(name):
        with metrics.span(name):
            go.wait()
            with metrics.span(name + ".inner"):
                go.wait()

    with metrics.collect("cpu") as rec:
        threads = [threading.Thread(target=worker, args=(n,)) for n in ("a", "b")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
    rec.resolve()
    spans = {s.name: s for s in rec.spans}
    for n in ("a", "b"):
        inner = spans[n + ".inner"]
        assert rec.spans[inner.parent] is spans[n] and inner.call == spans[n].call
    assert spans["a"].call != spans["b"].call


@pytest.mark.cuda
def test_on_the_card_spans_read_cuda_events(served):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from objectdetection_torch.ops import cuda_build

    try:
        cuda_build.nvcc_path()
    except RuntimeError:
        pytest.skip("no nvcc")
    dev = torch.device("cuda", 0)
    params, images, windows = served
    params = {k: v.to(dev) for k, v in params.items()}
    infer = detector.make_infer_fn(CFG, device=dev)
    infer(params, images, windows)  # builds the kernels, warms the card
    with metrics.collect() as rec:
        out = infer(params, images, windows)
    assert [s.name for s in rec.spans] == ["odtorch.infer", *STAGES]
    assert all(s.events is not None for s in rec.spans)
    rec.resolve()
    top, stages = rec.spans[0], rec.spans[1:]
    assert all(s.device_ms > 0 for s in stages)
    # one stream, stages in turn: their extents fit in the call's (events
    # resolve to about half a microsecond)
    assert sum(s.device_ms for s in stages) <= top.device_ms + 0.01
    assert rec.counters["mask_stage.rows"] == 2 * CFG.detection_post_nms_instances
    assert rec.counters["mask_stage.valid"] == int((out.scores > 0).sum())
