"""Device time of the port's fused int8 conv at the int8 Mask R-CNN call's shapes.

For each distinct conv of ``ops.int8_conv.mask_rcnn_convs(BATCH)`` (R-101 +
FPN at 1024², the RPN at P2-P6, the mask head on BATCH × 100 ROIs; default
batch 96, the benchmark's) with its epilogue, per channel: the kernel's ms a
call (CUDA events over REPS calls), the plain version's (im2col,
``torch._int_mm`` and the unfused ops: the path before the kernel), the
library GEMM alone (``torch._int_mm`` on the im2col matrix), and the bound
(``conv_bound``: operations at 1979 TOP/s or bytes at 3.35 TB/s). Prints one
JSON line: each conv's numbers, the sums over one call (each conv times its
calls) split into backbone, FPN, RPN and mask head, and the card's name and
power limit; each conv also on stderr.

    python3 tools/torch_int8_conv_time.py [BATCH]

Needs a CUDA card.
"""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from objectdetection_torch.ops import int8_conv as ic  # noqa: E402

REPS = 10
PEAK_OPS, PEAK_BYTES = 1979e12, 3.35e12


def event_ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def case(dev, b, h, w, cin, cout, k, stride, epilogue, pc=True, dtype=torch.bfloat16,
         padding=None, seed=0):
    """Seeded operands of one conv on ``dev``: (x8, k8, post, bias, the keyword
    arguments of ``int8_conv_fused`` for ``epilogue``, one of
    ``int8_conv.EPILOGUES``); sums of ~1 after ``post``, BatchNorm near 1,
    activation scales per channel (scalars without ``pc``) that clip a few
    codes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.rand(*shape, generator=g, device=dev)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    codes = lambda lo, *shape: torch.randint(lo, 128, shape, generator=g, device=dev,
                                             dtype=torch.int8)
    x8, k8 = codes(-128, b, h, w, cin), codes(-127, cout, cin, k, k)
    post = rand(cout) * 2 / (128 * 64 * (k * k * cin) ** 0.5)
    bias = randn(cout) * 0.1
    scale = lambda: (rand(cout) + 0.5) * 3 if pc else torch.tensor(2.0, device=dev)
    kw = dict(stride=stride, padding=padding, dtype=dtype)
    if epilogue != "bias":
        kw["bn"] = (rand(cout) + 0.5, randn(cout) * 0.1)
    if epilogue in ("ab", "c_proj", "c_id"):
        kw.update(relu=True, out_scale=scale())
    t, bo, l, r = ic.Q.conv_pads(padding, h, w, k, stride)
    ho, wo = (h + t + bo - k) // stride + 1, (w + l + r - k) // stride + 1
    if epilogue == "c_proj":
        kw["residual"] = (randn(b, ho, wo, cout) * 2).to(dtype)
    if epilogue == "c_id":
        kw["residual"] = (codes(-128, b, ho, wo, cout), scale())
    return x8, k8, post, bias, kw


def measure(conv, x8, k8, post, bias, kw):
    """One conv of ``mask_rcnn_convs`` on ``case``'s operands: the kernel's
    ms a call, its bound (operations at PEAK_OPS or bytes at PEAK_BYTES,
    ``conv_bound``), the plain version's ms and ``torch._int_mm``'s alone on
    the im2col matrix."""
    _, b, h, w, cin, cout, k, stride, epi, calls = conv
    out_bytes = 1 if "out_scale" in kw else 2
    ops, moved = ic.conv_bound(b, h, w, cin, cout, k, stride, out_bytes,
                               {"c_proj": 2, "c_id": 1}.get(epi, 0))
    row = {"calls": calls,
           "kernel_ms": event_ms(lambda: ic.int8_conv_fused(x8, k8, post, bias, **kw), REPS),
           "ops_ms": 1e3 * ops / PEAK_OPS, "bytes_ms": 1e3 * moved / PEAK_BYTES}
    row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
    row["bound_by"] = "operations" if row["ops_ms"] > row["bytes_ms"] else "bytes"
    row["plain_ms"] = event_ms(lambda: ic.int8_conv_fused_plain(x8, k8, post, bias, **kw), 2)
    cols = torch.zeros(b * -(-h // stride) * -(-w // stride), k * k * cin, dtype=torch.int8,
                       device=x8.device)
    wmat = k8.permute(2, 3, 1, 0).reshape(k * k * cin, cout)
    row["library_ms"] = event_ms(lambda: ic.Q.int8_matmul(cols, wmat), 2)
    del cols
    row["roofline_pct"] = 100 * row["bound_ms"] / row["kernel_ms"]
    return row


def part(name):
    return name.split()[0] if name.split()[0] in ("fpn", "rpn", "mask") else "backbone"


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    rows, sums = {}, {}
    for conv in ic.mask_rcnn_convs(batch):
        x8, k8, post, bias, kw = case(dev, *conv[1:9])
        row = measure(conv, x8, k8, post, bias, kw)
        del x8, k8, kw
        torch.cuda.empty_cache()
        rows[conv[0]] = row
        print(f"{conv[0]}: {json.dumps(row)}", file=sys.stderr, flush=True)
        s = sums.setdefault(part(conv[0]), {})
        for key in ("kernel_ms", "bound_ms", "plain_ms", "library_ms"):
            s[key] = s.get(key, 0.0) + row["calls"] * row[key]
    print(json.dumps({"card": card, "batch": batch, "per_call": sums, "convs": rows}))


if __name__ == "__main__":
    main()
