"""Device time of the port's NMS kernels in one checkout.

Times ``ops.nms.suppress`` on the four cases of ``chip_smoke.py`` phase 2
(``NMS_CASES``, B = 2: proposals 6000 -> 1000, detections 1000 -> 100,
training 6000 -> 2000, proposals-sparse 6000 -> 1000 over 600 clusters) with
torch.profiler, and prints one line of JSON: each case's device ms per call
and its split by kernel, with the card's name and power limit. The inputs
come from this checkout's ``chip_smoke.py``, the kernels from the checkout at
ROOT (default: this repository), so two versions of the kernels are compared
on one card, on the same inputs, by running this script on each in turns, in
one command:

    for r in OLD . . OLD; do python3 tools/torch_nms_time.py $r; done

Needs a CUDA card.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = sys.argv[1] if len(sys.argv) > 1 else str(HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from objectdetection_torch.ops import nms  # noqa: E402

REPS = 50


def load_cases():
    spec = importlib.util.spec_from_file_location("nms_cases", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.NMS_CASES, smoke.nms_case_inputs


def by_kernel(fn, reps: int):
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.split("::")[-1].split("(")[0]
            split[name] = split.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    if not split:
        raise RuntimeError("the profiler saw no device time")
    return split


def main():
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    cases, inputs = load_cases()
    res = {}
    for (name, _, _, _, _, thr, budget, _), (boxes, cls) in zip(cases, inputs(dev)):
        split = by_kernel(lambda: nms.suppress(boxes, cls, thr, budget), REPS)
        res[name] = sum(split.values())
        res[f"{name} by kernel"] = split
    print(json.dumps({"root": ROOT, "card": card, **res}))


if __name__ == "__main__":
    main()
