"""What a run loads: no JAX, no JAX package (top-level names compared
whole), in a fresh interpreter; the reference loads nothing of the
program; and the command refuses to run without a card or a program."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from perfbench import run

ROOT = run.ROOT


def fresh(code: str, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=600, env=env)


def test_a_run_of_every_cell_loads_no_jax():
    out = fresh(
        "from perfbench import run\n"
        "from perfbench.tests.conftest import TINY_SIZES, TINY_PARAMS\n"
        "for w in run.load_json(run.ROOT / 'BENCHMARK.json')['workloads']:\n"
        "    for trace in (False, True):\n"
        "        run.run_cell(w['name'], 3, 0.0, trace, 'cpu', sizes_override=TINY_SIZES,"
        " params_override=TINY_PARAMS)\n"
        "print('FOUND', run.forbidden_modules())\n")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"


def test_the_reference_loads_nothing_of_the_program():
    out = fresh(
        "import sys\n"
        "import perfbench.reference.layers, perfbench.reference.backbone\n"
        "import perfbench.reference.mask_rcnn\n"
        "import perfbench.reference.compare, perfbench.counts, perfbench.weights\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('objectdetection_torch', 'objectdetection_tpu', 'jax', 'flax')))\n")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("objectdetection_torch.ops", "jaxtyping", "flaxen", "optaxx"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "objectdetection_tpu.config", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax.numpy", "objectdetection_tpu.config"]


def test_no_card_no_line():
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "maskrcnn-int8-b96", "--seed", "2147483700", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "maskrcnn-bf16-b96", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
