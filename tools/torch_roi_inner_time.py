"""Device time of the port's P2 probe kernel (ROI inner) in one checkout.

Times ``probes.roi_inner.roi_inner`` on each of its six variants at the TPU
script's size (``make_inputs``: 96000 ROIs from ``RandomState(0)``) with
torch.profiler, and prints one line of JSON: device ms per call of each
variant, whether it equals the plain version, the plain version's ms (CUDA
events) and the bound (``work``: bytes at 3.35 TB/s, or the f32 and bf16
operations at their peaks), the sums of the three, a digest of each output,
and the card's name and power limit (and, for a variant whose kernel records
the profiler lost, how many it saw). Run it on two checkouts in turns, in one
command, to compare two versions of the kernel on one card (ROOT, default
this repository, names the checkout whose package is imported; both draw the
same inputs):

    for r in OLD . . OLD; do python3 tools/torch_roi_inner_time.py $r; done

Needs a CUDA card.
"""

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = sys.argv[1] if len(sys.argv) > 1 else str(HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch_kernel_cases as kc  # noqa: E402

from objectdetection_torch.probes import common, roi_inner  # noqa: E402

REPS = 20


def digest(out: torch.Tensor) -> str:
    """A checksum of the output's bits, computed on the card."""
    rows = out.view(torch.int16).reshape(-1, 7 * roi_inner.C)
    weights = torch.arange(1, rows.shape[1] + 1, device=out.device, dtype=torch.int64)
    total = 0
    for s in range(0, rows.shape[0], 65536):
        total += int((rows[s:s + 65536].to(torch.int64) * weights).sum())
    return f"{total & 0xFFFFFFFFFFFF:012x}"


def device_ms(fn, reps: int):
    """Device ms per call of everything ``fn`` launches (torch.profiler), and
    how many launches of the probe's kernel the profiler recorded."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3 / reps
    seen = sum(e.count for e in events if "roi_inner" in e.key)
    if not total > 0:
        raise RuntimeError("the profiler saw no device time")
    return total, seen


def bound_ms(moved: int, f32_ops: int, mm_ops: int) -> float:
    """The bound of ``work``'s counts: bytes at 3.35 TB/s, or the f32 and the
    bf16 tensor-core operations at their peaks."""
    return max(moved / kc.PEAK_BYTES, f32_ops / kc.PEAK_F32 + mm_ops / kc.PEAK_BF16) * 1e3


def main():
    dev = torch.device("cuda", 0)
    args = roi_inner.make_inputs(device=dev)
    res, total = {}, {"sum": 0.0, "plain sum": 0.0, "bound sum": 0.0}
    for v in roi_inner.VARIANTS:
        out = roi_inner.roi_inner(*args, v)  # checks the error flag once
        res[f"{v} digest"] = digest(out)
        res[f"{v} equal to plain"] = bool(torch.equal(out, roi_inner.roi_inner_plain(*args, v)))
        del out
        ms, launches = device_ms(lambda: roi_inner._launch(*args, v), REPS)
        res[v] = ms
        if launches != REPS:  # the profiler lost kernel records: the mean is not one
            res[f"{v} kernels seen"] = launches
        res[f"{v} plain ms"] = common.timed(lambda: roi_inner.roi_inner_plain(*args, v), 1,
                                            dev)[0]
        res[f"{v} bound ms"] = bound_ms(*roi_inner.work(args[0].shape[0], v))
        for key, suffix in (("sum", ""), ("plain sum", " plain ms"), ("bound sum", " bound ms")):
            total[key] += res[f"{v}{suffix}"]
    print(json.dumps({"root": ROOT, "card": common.card(), **total, **res}))


if __name__ == "__main__":
    main()
