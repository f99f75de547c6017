"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is comes from files found by name: the cell
``perfbench/workloads/<cell>.json`` (configuration, traffic mix, the
measurement's parameters, the limits of the correctness check), the
configuration ``perfbench/configs/<config>.json`` (the model's sizes and
precision as they are run, and the ``system`` module beside it that builds
and runs them, ``perfbench/configs/<system>.py``), the traffic mix
``perfbench/traffic/<traffic>.json`` (its parameters, and the ``kind`` of
generator that reads them, ``perfbench/traffic/<kind>.py``), and for
``--trace 1`` one reader ``perfbench/metrics/<metric>.py`` for each
per-layer metric that ``BENCHMARK.json`` lists for the cell, which the
traffic calls with its layer context (see ``perfbench/metrics/__init__.py``).

With ``--trace 0`` the line's ``metrics`` are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (and ``device`` gains ``busy_s``
and ``window_s``, and the line a ``breakdown``). ``correct`` is the
comparison of a sample of the window's answers with the plain reference,
each number within its limit; the numbers and limits are the last lines on
stderr and the line's last key, ``checks``. The run exits 1 without a line
when there is no card (or fewer than the cell asks for), and 3 when a JAX
module is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "objectdetection_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: Path):
    """The Python file ``path`` as a module (names may hold dots)."""
    name = "perfbench_file_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0]


def checks_of(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "bound"}} for each limited number;
    ``bound`` is ``max`` (the number may not exceed the limit) or ``min``."""
    out = {}
    for name, lim in limits.items():
        bound, limit = next(iter(lim.items()))
        out[name] = {"value": numbers.get(name, math.nan), "limit": limit, "bound": bound}
    return out


def passed(check: dict) -> bool:
    v, lim = check["value"], check["limit"]
    if not math.isfinite(v):
        return False
    return v <= lim if check["bound"] == "max" else v >= lim


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             sizes_override: dict = None, params_override: dict = None,
             system_wrap=None) -> dict:
    """One run of the cell ``name``; returns the line's dict (without
    printing). The overrides and ``system_wrap`` (a function of the
    configuration's System class) exist for the tests."""
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = load_json(HERE / "workloads" / f"{name}.json")
    sizes = {**load_json(HERE / "configs" / f"{cell['config']}.json"), **(sizes_override or {})}
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    params = {**mix, **cell["params"], **(params_override or {})}
    system_cls = load_module(HERE / "configs" / f"{sizes['system']}.py").System
    if system_wrap is not None:
        system_cls = system_wrap(system_cls)
    traffic = load_module(HERE / "traffic" / f"{mix['kind']}.py")
    readers = {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py")
               for m in bench["per_layer"] if trace and applies(m, name)}
    dev = torch.device(device)
    ctx = SimpleNamespace(params=params, sizes=sizes, device=dev, log=log, seed=int(seed),
                          seconds=float(seconds), trace=bool(trace), system_cls=system_cls,
                          readers=readers,
                          t_start=_T0 if device == "cuda" else time.perf_counter())
    res = traffic.run(ctx)

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if trace:
        for m_name, value in res["layers"].items():
            if value is not None:
                metrics[m_name] = {"value": float(value), "unit": units[m_name]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": float(res["metrics"][m["name"]]),
                                      "unit": units[m["name"]]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace:
        from perfbench import trace as trace_lib

        tr = res["trace"]
        device_info["busy_s"] = trace_lib.union_s(tr.device, tr.window)
        device_info["window_s"] = tr.window_s
    checks = checks_of(res["numbers"], cell["checks"])
    line = {"correct": all(passed(c) for c in checks.values()), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device_info}
    if trace:
        line["breakdown"] = res["breakdown"]
    line["numbers"] = res["numbers"]
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = load_json(HERE / "workloads" / f"{args.workload}.json")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 1
    cache = ROOT / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    torch.set_num_threads(4)
    log(f"card: {card()}")
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        log(f"perfbench: JAX modules loaded in the run's process: {found}")
        return 3
    for k, c in line["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
