"""Device time of the port's anchor-match kernel in one checkout.

Times ``ops.anchor_match.anchor_match`` on ``chip_smoke.py`` phase 5's
inputs (the COCO anchors, A = 261,888, x 100 GT boxes, B = 2, from
``match_inputs`` with its seed) with torch.profiler, and prints one line of
JSON: device ms per call and its split by kernel, the launches of each
kernel the profiler recorded, a digest of the outputs, and the card's name
and power limit. The inputs come from this checkout's
``chip_smoke.py``, the kernel from the checkout at ROOT (default: this
repository), so two versions are compared on one card, on the same inputs,
by running this script on each in turns, in one command:

    for r in OLD . . OLD; do python3 tools/torch_anchor_match_time.py $r; done

Needs a CUDA card.
"""

import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = sys.argv[1] if len(sys.argv) > 1 else str(HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from objectdetection_torch.anchors import config_anchors  # noqa: E402
from objectdetection_torch.config import COCO_CONFIG  # noqa: E402
from objectdetection_torch.ops import anchor_match  # noqa: E402

REPS = 100


def load_smoke():
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def by_kernel(fn, reps: int):
    """Device ms per call of each kernel ``fn`` launches, and how many
    launches of each the profiler recorded (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split, seen = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.split("::")[-1].split("(")[0]
            split[name] = split.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
            seen[name] = seen.get(name, 0) + e.count
    if not split:
        raise RuntimeError("the profiler saw no device time")
    return split, seen


def main():
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    smoke = load_smoke()
    anchors = torch.from_numpy(config_anchors(COCO_CONFIG)).to(dev)
    gt, valid = smoke.match_inputs(torch.Generator().manual_seed(5), anchors,
                                   COCO_CONFIG.max_gt_objects, dev)
    call = lambda: anchor_match.anchor_match(anchors, gt, valid)
    out = call()
    want = anchor_match.anchor_match_plain(anchors, gt, valid)
    same = all(torch.equal(k, w) for k, w in zip(out, want))
    digest = hashlib.sha1(b"".join(t.cpu().numpy().tobytes() for t in out)).hexdigest()[:12]
    split, seen = by_kernel(call, REPS)
    print(json.dumps({"root": ROOT, "card": card, "ms": sum(split.values()), "by kernel": split,
                      "kernels seen": seen, "reps": REPS, "equal to plain": same,
                      "digest": digest}))


if __name__ == "__main__":
    main()
