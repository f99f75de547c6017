"""Device time of the port's NMS kernels in one checkout.

Times ``ops.nms.suppress`` on the cases of ``tools/torch_kernel_cases.py``
(``NMS_CASES``, B = 2: proposals 6000 -> 1000, detections 1000 -> 100,
training 6000 -> 2000, proposals-sparse 6000 -> 1000 over 600 clusters, the
published RetinaNet's 5000 rows of 80 classes -> 100) with torch.profiler,
and prints one line of JSON: each case's device ms per call and its split by
kernel, whether it equals the plain version, and for the serving path's two
cases the plain version's ms (CUDA events) and the bound (the rows the sweep
resolves: their bytes at 3.35 TB/s, or the IoU tests greedy NMS needs on
this data at 67 TFLOP/s f32), summed in ``B2``, with the card's name and
power limit. The inputs come from this checkout's tools, the kernels from
the checkout at ROOT (default: this repository), so two versions of the
kernels are compared on one card, on the same inputs, by running this script
on each in turns, in one command:

    for r in OLD . . OLD; do python3 tools/torch_nms_time.py $r; done

Needs a CUDA card.
"""

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = sys.argv[1] if len(sys.argv) > 1 else str(HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch_kernel_cases as cases  # noqa: E402

from objectdetection_torch.ops import nms  # noqa: E402
from objectdetection_torch.probes import common  # noqa: E402

REPS = 50


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
    res = {}
    b2 = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for (name, n, _, _, _, thr, budget, serving), (boxes, cls) in zip(
            cases.NMS_CASES, cases.nms_case_inputs(dev)):
        call = lambda: nms.suppress(boxes, cls, thr, budget)
        split = by_kernel(call, REPS)
        res[name] = sum(split.values())
        res[f"{name} by kernel"] = split
        want = nms.suppress_plain(boxes, cls, thr, budget)
        res[f"{name} equal to plain"] = bool(torch.equal(call(), want))
        if serving:
            rows = cases.stop_row(want, nms.TILE, budget)
            plain_ms = common.timed(lambda: nms.suppress_plain(boxes, cls, thr, budget), 3,
                                    dev)[0]
            b2["ms"] += res[name]
            b2["plain_ms"] += plain_ms
            b2["bytes_ms"] += cases.BATCH * n * (16 + 4 + 16) / cases.PEAK_BYTES * 1e3
            b2["ops_ms"] += cases.nms_ops(want, cls, rows) / cases.PEAK_F32 * 1e3
            res[f"{name} plain ms"] = plain_ms
    b2["bound_ms"] = max(b2["bytes_ms"], b2["ops_ms"])
    b2["bound_by"] = "bytes" if b2["bytes_ms"] >= b2["ops_ms"] else "operations"
    print(json.dumps({"root": ROOT, "card": common.card(), "B2": b2, **res}))


if __name__ == "__main__":
    main()
