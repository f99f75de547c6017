"""Device time of the port's P1 probe kernel (patch DMA) in one checkout.

Times ``probes.patch_dma.patch_dma`` on its three (ROIs, patch) cases at the
TPU script's size (``make_source``: a [32, 256, 256, 256] bf16 source;
``make_indices``) with torch.profiler, and prints one line of JSON: each
case's device ms per call, whether it lies within ``tolerance`` of the plain
version, the plain version's ms and the library yardstick's (one
advanced-index gather of every patch, ``library_call``; CUDA events), the
bound (every patch read once at 3.35 TB/s, ``patch_bytes``), the sums over
the cases, and the card's name and power limit. ROOT (default: this
repository) names the checkout whose package is imported, so two versions
are compared on one card by running this script on each in turns, in one
command:

    for r in OLD . . OLD; do python3 tools/torch_patch_dma_time.py $r; done

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

from objectdetection_torch.probes import common, patch_dma  # noqa: E402

REPS = 10


def main():
    dev = torch.device("cuda", 0)
    src = patch_dma.make_source(device=dev)
    res, total = {}, {"sum": 0.0, "plain sum": 0.0, "library sum": 0.0, "bound sum": 0.0}
    for n, p in patch_dma.CASES:
        i, y, xq = patch_dma.make_indices(n, p, device=dev)
        got = patch_dma.patch_dma(src, i, y, xq, p)  # checks the error flag once
        want = patch_dma.patch_dma_plain(src, i, y, xq, p)
        ok = bool(((got.double() - want.double()).abs()
                   <= patch_dma.tolerance(src, i, y, xq)).all())
        row = {"ms": common.device_ms(lambda: patch_dma._launch(src, i, y, xq, p), REPS),
               "within tolerance of plain": ok,
               "plain ms": common.timed(lambda: patch_dma.patch_dma_plain(src, i, y, xq, p), 3,
                                        dev)[0],
               "library ms": common.timed(lambda: patch_dma.library_call(src, i, y, xq, p), 3,
                                          dev)[0],
               "bound ms": patch_dma.patch_bytes(n, p, src.shape[-1]) / kc.PEAK_BYTES * 1e3}
        res[f"{n}x{p}"] = row
        for key, what in (("sum", "ms"), ("plain sum", "plain ms"),
                          ("library sum", "library ms"), ("bound sum", "bound ms")):
            total[key] += row[what]
    print(json.dumps({"root": ROOT, "card": common.card(), **total, **res}))


if __name__ == "__main__":
    main()
