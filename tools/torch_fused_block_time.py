"""Device time of the port's fused int8 bottleneck block in one checkout.

Times ``ops.fused_block.fused_identity_block_int8`` at the four ResNet stage
shapes of a 1024² batch of 2 (``tools/torch_kernel_cases.py``: ``STAGES``,
``block_case``, the kernels as HWIO views of OIHW storage as the backbone
passes them) with torch.profiler, and prints one line of JSON: each stage's
device ms per call, split into the block kernel and everything else the
wrapper launches (the preparation), whether it equals the plain version, the
plain version's ms (CUDA events), the bound (``block_bound``: int8
operations at 1979 TOP/s or bytes at 3.35 TB/s), the per-batch sums over
R101's identity blocks (2/3/22/2), a digest of each output, and the card's
name and power limit. The inputs come from this checkout's tools, the
kernels from the checkout at ROOT (default: this repository), so two
versions are compared on one card, on the same inputs, by running this
script on each in turns, in one command:

    for r in OLD . . OLD; do python3 tools/torch_fused_block_time.py $r; done

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

from objectdetection_torch.ops import fused_block  # noqa: E402
from objectdetection_torch.probes import common  # noqa: E402

REPS = 20


def split_ms(fn, reps: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = common.per_call_ms(prof, reps)
    if not split:
        raise RuntimeError("the profiler saw no device time")
    return split


def main():
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)
    res = {}
    batch = {"kernel": 0.0, "preparation": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for (h, w, c3, c1), n in zip(cases.STAGES, cases.STAGE_BLOCKS):
        args = cases.block_case(gen, h, w, c3, c1, dev)
        split = split_ms(lambda: fused_block.fused_identity_block_int8(*args), REPS)
        kernel = sum(v for k, v in split.items() if "fused_block_kernel" in k)
        prep = sum(split.values()) - kernel
        out = fused_block.fused_identity_block_int8(*args)
        want = fused_block.fused_identity_block_int8_plain(*args)
        plain_ms = common.timed(lambda: fused_block.fused_identity_block_int8_plain(*args), 3,
                                dev)[0]
        ops, moved = fused_block.block_bound(cases.BATCH, h, w, c3, c1)
        bound = max(ops / cases.PEAK_INT8, moved / cases.PEAK_BYTES) * 1e3
        name = f"{h}x{w}x{c3}/{c1}"
        res[name] = {"kernel": kernel, "preparation": prep, "kernels": len(split),
                     "digest": hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()[:12],
                     "equal to plain": bool(torch.equal(out, want)), "plain_ms": plain_ms,
                     "bound_ms": bound}
        for key, v in (("kernel", kernel), ("preparation", prep), ("plain_ms", plain_ms),
                       ("bound_ms", bound)):
            batch[key] += n * v
        del args, out, want
    batch["total"] = batch["kernel"] + batch["preparation"]
    print(json.dumps({"root": ROOT, "card": common.card(), **res, "batch of 29": batch}))


if __name__ == "__main__":
    main()
