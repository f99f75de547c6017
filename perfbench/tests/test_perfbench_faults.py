"""A run whose timed path is broken underneath must come out not correct.

Each test skips the harness's look for a card (``run.run_cell`` on the
CPU at the tests' small size) and drives the rest of a run of the cell,
with the cell's own limits, once for each fault an inference cell can
have: half of the batch left out, and every answer altered where it is
produced. (The control, the reference one precision lower in the
program's place, is the card test ``test_perfbench_control.py``.)
"""

from __future__ import annotations

import pytest

from perfbench import faults, run
from perfbench.tests.conftest import TINY_PARAMS, TINY_SIZES

CELLS = [w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("fault", [faults.half_batch, faults.altered],
                         ids=["half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    line = run.run_cell(cell, 4, 0.0, False, "cpu", sizes_override=TINY_SIZES,
                        params_override=TINY_PARAMS, system_wrap=fault)
    assert line["numbers"]["detections_per_image"] >= 1, "the sample must hold detections"
    assert line["correct"] is False, line["checks"]
    assert list(line)[-1] == "checks"
