"""The readings that a cell's limits are set from, on the card.

    python3 -m perfbench.readings --workload <cell> --seeds 11,12,13 [--control]

For each seed, one run of the cell with a window of one batch (the cell's
own load) and no warm-up, with the program, or with ``--control`` the
control in its place (:func:`perfbench.faults.control`); prints one JSON
line a seed with every number the comparison gives and whether the
cell's limits passed. Several seeds share one process and its kernel build.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)

    import torch

    from perfbench import faults, run

    if not torch.cuda.is_available():
        run.log("perfbench.readings: no CUDA device")
        return 1
    for seed in (int(s) for s in args.seeds.split(",")):
        line = run.run_cell(args.workload, seed, 0.0, False, "cuda",
                            params_override={"warm": 0},
                            system_wrap=faults.control if args.control else None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control" if args.control else "program",
                          "correct": line["correct"], "numbers": line["numbers"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
