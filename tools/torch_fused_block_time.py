"""Device time of the port's fused int8 bottleneck block in one checkout.

Times ``ops.fused_block.fused_identity_block_int8`` at the four ResNet stage
shapes of ``chip_smoke.py`` phase 7a (``STAGES``, a 1024² batch of 2, the
kernels as HWIO views of OIHW storage as the backbone passes them) with
torch.profiler, and prints one line of JSON: each stage's device ms per call,
split into the block kernel and everything else the wrapper launches (the
preparation), the per-batch sum over R101's identity blocks (2/3/22/2), a
digest of each output, and the card's name and power limit. The inputs come
from this checkout's ``chip_smoke.py``, the kernels from the checkout at ROOT
(default: this repository), so two versions are compared on one card, on the
same inputs, by running this script on each in turns, in one command:

    for r in OLD . . OLD; do python3 tools/torch_fused_block_time.py $r; done

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

from objectdetection_torch.ops import fused_block  # noqa: E402

REPS = 20


def load_smoke():
    spec = importlib.util.spec_from_file_location("block_cases", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main():
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    smoke = load_smoke()
    gen = torch.Generator().manual_seed(7)
    res, batch = {}, {"kernel": 0.0, "preparation": 0.0}
    for (h, w, c3, c1), n in zip(smoke.STAGES, smoke.STAGE_BLOCKS):
        args = smoke.block_case(gen, h, w, c3, c1, dev)
        split = smoke.device_split(lambda: fused_block.fused_identity_block_int8(*args), REPS)
        kernel = sum(v for k, v in split.items() if "fused_block_kernel" in k)
        prep = sum(split.values()) - kernel
        out = fused_block.fused_identity_block_int8(*args)
        name = f"{h}x{w}x{c3}/{c1}"
        res[name] = {"kernel": kernel, "preparation": prep, "kernels": len(split),
                     "digest": hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()[:12]}
        batch["kernel"] += n * kernel
        batch["preparation"] += n * prep
    batch["total"] = batch["kernel"] + batch["preparation"]
    print(json.dumps({"root": ROOT, "card": card, **res, "batch of 29": batch}))


if __name__ == "__main__":
    main()
