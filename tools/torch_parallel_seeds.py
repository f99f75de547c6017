#!/usr/bin/env python3
"""Phase 12(b)-(c) of ``chip_smoke.py`` over several target-noise seeds, on one card.

    python3 tools/torch_parallel_seeds.py [--seeds 10] [--first 3]

Builds the kernels, runs 12(a) once (NCCL at world 1, seeded COCO_CONFIG
weights), then 12(b)-(c) once for each noise seed ``first``,
``first + 1``, ...: two gloo ranks on the card, their targets and two f32
steps held against the single process's whole-batch and one-image steps,
and the dp × tp = 1 × 2 step, exactly as ``chip_smoke.py`` holds them. A
seed whose checks fail is reported and the sweep goes on; the exit code
is the number of failed seeds. Every line the phase logs is printed.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


class Failed(Exception):
    pass


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--first", type=int, default=3)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from objectdetection_torch import convert
    from objectdetection_torch.config import COCO_CONFIG

    def fail(msg):
        raise Failed(msg)

    cs.fail = fail
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = cs.card_and_build()
    params = convert.init_params(COCO_CONFIG, torch.Generator().manual_seed(0), device)
    single_det, launches = cs.parallel_nccl(params, card)
    print(f"12(a) launches {launches}", flush=True)
    failed = 0
    for seed in range(args.first, args.first + args.seeds):
        cs.NOISE_SEED = seed
        t0 = time.perf_counter()
        try:
            launches = cs.parallel_ranks(params, single_det, card)
            print(f"seed {seed}: ok, launches {launches}", flush=True)
        except Failed as e:
            failed += 1
            print(f"seed {seed}: FAILED {e}", flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"{failed} of {args.seeds} seeds failed [{card}]", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(main())
