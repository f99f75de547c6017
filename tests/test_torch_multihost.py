"""Starting the port's process group across processes on the CPU (gloo).

Mirrors tests/test_multihost.py: two local processes rendezvous through
``parallel.initialize_multihost`` at a localhost coordinator, assert the
world's size and their ranks, and all-reduce ``rank + 1`` to 3.0 across the
process boundary. The same with the variables a ``torchrun`` launch sets
(``python -m torch.distributed.run --standalone --nproc_per_node 2``) and no
arguments. Slow: ``cli.run_eval_coco(data_parallel=True)`` (the ``eval-coco
--data-parallel`` command) under that launch hands its evaluator, on every
rank, the single-process run's class ids and its boxes and scores within
rtol/atol 1e-4 (each rank infers a batch of 1, the single process a batch
of 2), and the same mAP within 1e-6.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 180
# a rank molds and infers one image where the single process infers two at
# once: the inference parity's tolerance on what reaches the evaluator
TOL = dict(rtol=1e-4, atol=1e-4)

WORKER = r"""
import sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from objectdetection_torch import parallel

args = sys.argv[1:]
if args:  # coordinator, rank
    parallel.initialize_multihost(args[0], num_processes=2, process_id=int(args[1]),
                                  device="cpu")
else:  # the variables torchrun sets
    parallel.initialize_multihost(device="cpu")
rank = dist.get_rank()
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
assert rank == (int(args[1]) if args else int(__import__("os").environ["RANK"]))
mesh = parallel.make_mesh(2, device="cpu")
assert mesh.shape == (2,) and parallel.data_rank(mesh) == rank
x = torch.tensor([float(rank + 1)])
dist.all_reduce(x)
assert float(x) == 3.0, float(x)
dist.destroy_process_group()
print(f"worker {rank} ok", flush=True)
"""

EVAL_WORKER = r"""
import json
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from objectdetection_torch import cli, evaluate
from objectdetection_torch.config import SHAPES_CONFIG

ann_file, root, config, out = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), sys.argv[4]
rows = []
add = evaluate.DetectionEvaluator.add_image


def record(self, *args, **kwargs):
    rows.append([np.asarray(x) for x in args[:3]])
    return add(self, *args, **kwargs)


evaluate.DetectionEvaluator.add_image = record
cfg = SHAPES_CONFIG.replace(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in config.items()})
results, _ = cli.run_eval_coco(ann_file, root, config=cfg, batch=2, data_parallel=True,
                               device="cpu")
rank = int(__import__("os").environ["RANK"])
np.savez(f"{out}/eval_{rank}.npz", mAP=results["mAP"],
         **{f"{i}/{j}": x for i, row in enumerate(rows) for j, x in enumerate(row)})
print(f"worker {rank} ok", flush=True)
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env():
    e = {k: v for k, v in os.environ.items()
         if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                      "LOCAL_RANK")}
    e["PYTHONPATH"] = str(ROOT)
    return e


def finish(procs):
    """Each process's output, after it exits (killed at TIMEOUT)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def torchrun(script, *args, cwd):
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", str(script), *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env(), cwd=str(cwd))
    (out,) = finish([proc])
    assert proc.returncode == 0, out
    return out


def test_initialize_multihost_two_processes(tmp_path):
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, coordinator, str(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env(), cwd=str(tmp_path))
             for pid in range(2)]
    for pid, (p, out) in enumerate(zip(procs, finish(procs))):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"worker {pid} ok" in out


def test_initialize_multihost_reads_a_torchrun_launch(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = torchrun(script, cwd=tmp_path)
    assert "worker 0 ok" in out and "worker 1 ok" in out


@pytest.mark.slow  # two processes evaluate a small model each
def test_eval_coco_data_parallel_under_torchrun(tmp_path, monkeypatch):
    from test_torch_cli import SMALL, TCFG, tiny_coco

    from objectdetection_torch import cli, evaluate

    ann_file, root = tiny_coco(tmp_path)
    script = tmp_path / "eval_worker.py"
    script.write_text(EVAL_WORKER)
    torchrun(script, ann_file, root, json.dumps(SMALL), str(tmp_path), cwd=tmp_path)

    rows = []
    add = evaluate.DetectionEvaluator.add_image

    def record(self, *args, **kwargs):
        rows.append([np.asarray(x) for x in args[:3]])
        return add(self, *args, **kwargs)

    monkeypatch.setattr(evaluate.DetectionEvaluator, "add_image", record)
    want, _ = cli.run_eval_coco(ann_file, root, config=TCFG, batch=2, device="cpu")
    assert sum(len(r[0]) for r in rows) > 0
    for rank in range(2):
        got = np.load(tmp_path / f"eval_{rank}.npz")
        assert abs(float(got["mAP"]) - want["mAP"]) <= 1e-6
        for i, (boxes, class_ids, scores) in enumerate(rows):
            np.testing.assert_array_equal(got[f"{i}/1"], class_ids)
            np.testing.assert_allclose(got[f"{i}/0"], boxes, **TOL)
            np.testing.assert_allclose(got[f"{i}/2"], scores, **TOL)
