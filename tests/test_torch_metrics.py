"""The port's ``metrics`` against ``objectdetection_tpu.metrics`` on the same
inputs: the debug checks' counts and messages, ``StepTimer``'s separation of
the first call, ``MetricLogger``'s rows and jsonl file, and the trace file."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu import metrics as jm

from objectdetection_torch import metrics as tm

torch.set_num_threads(1)


@pytest.fixture
def checks_on():
    jm.enable_debug_checks(True)
    tm.enable_debug_checks(True)
    yield
    jm.enable_debug_checks(False)
    tm.enable_debug_checks(False)


def boxes_case():
    rng = np.random.RandomState(0)
    boxes = rng.uniform(-0.2, 1.2, (2, 9, 4)).astype(np.float32)
    boxes[0, 0] = [0.5, 0.5, 0.2, 0.9]  # inverted
    boxes[1, 3, 2] = np.nan
    return boxes


def jax_lines(capfd, fn):
    fn()
    jax.effects_barrier()
    return capfd.readouterr().out.strip().splitlines()


def test_debug_checks_print_jax_counts_and_messages(checks_on, capfd):
    x = np.array([[1.0, np.nan, np.inf], [-np.inf, 0.0, 2.0]], np.float32)
    boxes = boxes_case()
    want = jax_lines(capfd, lambda: (jm.check_finite(jnp.asarray(x), "logits"),
                                     jm.check_boxes(jnp.asarray(boxes), "rois")))
    assert tm.check_finite(torch.from_numpy(x), "logits") is not None
    tm.check_boxes(torch.from_numpy(boxes), "rois")
    got = capfd.readouterr().out.strip().splitlines()
    assert got == want
    assert want[0] == "[check_finite] logits: 3 non-finite of 6"


def test_debug_checks_off_return_the_input_and_print_nothing(capfd):
    x = torch.tensor([float("nan")])
    assert tm.check_finite(x, "x") is x
    assert tm.check_boxes(x, "x") is x
    assert capfd.readouterr().out == ""


def test_step_timer_keeps_the_first_call_apart():
    for timer in (jm.StepTimer(), tm.StepTimer()):
        for _ in range(3):
            with timer:
                pass
        s = timer.summary()
        assert set(s) == {"compile_s", "mean_step_s", "steps"}
        assert s["steps"] == 2 and timer.compile_time is not None
        assert len(timer.step_times) == 2


def test_metric_logger_rows_and_jsonl_match_jax(tmp_path):
    rows = [(0, {"loss": np.float32(1.5), "lr": 0.01, "tag": "a"}),
            (1, {"loss": np.float32(0.25), "lr": 0.02, "tag": "b"})]
    paths = [tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"]
    loggers = [jm.MetricLogger(str(paths[0])), tm.MetricLogger(str(paths[1]))]
    for step, m in rows:
        jr = loggers[0].log(step, **{k: jnp.asarray(v) if k == "loss" else v
                                     for k, v in m.items()})
        tr = loggers[1].log(step, **{k: torch.tensor(v) if k == "loss" else v
                                     for k, v in m.items()})
        assert jr == tr
    assert loggers[0].latest() == loggers[1].latest()
    assert paths[0].read_text() == paths[1].read_text()
    assert json.loads(paths[1].read_text().splitlines()[-1])["tag"] == "b"


def test_trace_writes_a_chrome_trace(tmp_path):
    with tm.trace(str(tmp_path / "t")):
        torch.ones(4).sum()
    path = tmp_path / "t" / "trace.json"
    assert os.path.getsize(path) > 0
    assert "traceEvents" in json.loads(path.read_text())
