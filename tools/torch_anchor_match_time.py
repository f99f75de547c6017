"""Device time of the port's anchor-match kernel in one checkout.

Times ``ops.anchor_match.anchor_match`` on the COCO anchors, A = 261,888,
x 100 GT boxes, B = 2 (``tools/torch_kernel_cases.py`` ``match_inputs`` with
its seed) with torch.profiler, and prints one line of JSON: device ms per
call and its split by kernel, the launches of each kernel the profiler
recorded, a digest of the outputs, whether they equal the plain version,
the plain version's ms (CUDA events), the bound (the pairs whose boxes
overlap, 19 f32 operations each at 67 TFLOP/s, or the bytes at 3.35 TB/s;
the dense count of every anchor with every valid GT beside it), and the
card's name and power limit. The inputs come from this checkout's tools,
the kernel from the checkout at ROOT (default: this repository), so two
versions are compared on one card, on the same inputs, by running this
script on each in turns, in one command:

    for r in OLD . . OLD; do python3 tools/torch_anchor_match_time.py $r; done

Needs a CUDA card.
"""

import hashlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = sys.argv[1] if len(sys.argv) > 1 else str(HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch_kernel_cases as cases  # noqa: E402

from objectdetection_torch.anchors import config_anchors  # noqa: E402
from objectdetection_torch.config import COCO_CONFIG  # noqa: E402
from objectdetection_torch.geometry import iou_matrix  # noqa: E402
from objectdetection_torch.ops import anchor_match  # noqa: E402
from objectdetection_torch.probes import common  # noqa: E402

REPS = 100


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
    anchors = torch.from_numpy(config_anchors(COCO_CONFIG)).to(dev)
    g = COCO_CONFIG.max_gt_objects
    gt, valid = cases.match_inputs(torch.Generator().manual_seed(5), anchors, g, dev)
    call = lambda: anchor_match.anchor_match(anchors, gt, valid)
    out = call()
    want = anchor_match.anchor_match_plain(anchors, gt, valid)
    same = all(torch.equal(k, w) for k, w in zip(out, want))
    digest = hashlib.sha1(b"".join(t.cpu().numpy().tobytes() for t in out)).hexdigest()[:12]
    split, seen = by_kernel(call, REPS)
    plain_ms = common.timed(lambda: anchor_match.anchor_match_plain(anchors, gt, valid), 3,
                            dev)[0]
    # the bound counts the tests no exact kernel can skip: the pairs whose
    # boxes overlap (IoU > 0 with a valid GT); the kernel culls the rest by tile
    a, b = anchors.shape[0], cases.BATCH
    overlap = int(((iou_matrix(anchors, gt) > 0) & valid[:, None, :]).sum())
    dense = a * int(valid.sum())
    bytes_ms = (a * 16 + gt.numel() * 4 + valid.numel() + b * a * 8 + b * g * 8) \
        / cases.PEAK_BYTES * 1e3
    ops_ms = overlap * cases.MATCH_OPS / cases.PEAK_F32 * 1e3
    dense_ms = dense * cases.MATCH_OPS / cases.PEAK_F32 * 1e3
    print(json.dumps({"root": ROOT, "card": common.card(), "ms": sum(split.values()),
                      "by kernel": split, "kernels seen": seen, "reps": REPS,
                      "equal to plain": same, "digest": digest, "plain_ms": plain_ms,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                      "bytes_ms": bytes_ms, "ops_ms": ops_ms, "overlapping pairs": overlap,
                      "dense pairs": dense,
                      "dense bound_ms": max(bytes_ms, dense_ms)}))


if __name__ == "__main__":
    main()
