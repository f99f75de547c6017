"""The control comes out not correct: on the card, at each cell's own size,
the reference computed one precision below the configuration's (int4 for
the int8 recipe, calibrated as it is; fp8 for bf16) in the program's place,
judged against the float32 reference by the cell's own limits, on three
seeds. The program on the same seeds comes out correct.

    python -m pytest perfbench/tests/test_perfbench_control.py -q -m cuda
"""

from __future__ import annotations

import pytest

from perfbench import faults, run

CELLS = [w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_and_the_program_is(cell, card):
    for seed in (901, 902, 903):
        control = run.run_cell(cell, seed, 0.0, False, "cuda", params_override={"warm": 0},
                               system_wrap=faults.control)
        assert control["correct"] is False, (seed, control["checks"])
        program = run.run_cell(cell, seed, 0.0, False, "cuda", params_override={"warm": 0})
        assert program["correct"] is True, (seed, program["checks"])
