"""Device time of the float conv's epilogue pass (E1) at R-101 ResNetFPN's shapes.

For each distinct site of ``ops.conv_epilogue.resnet_fpn_sites(BATCH)`` in
R-101's two pyramids (P2-P6 and RetinaNet's P3-P7; default batch 96, the
benchmark's), in bf16: the kernel held bit-equal to the plain version, then
its ms a call and the plain version's (the unfused chain; CUDA events around
back-to-back calls) and the bound (``site_bytes`` at 3.35 TB/s), failing
where the kernel would beat HBM by more than 5%; the sums over one call of
each pyramid (each site times its calls). Then a whole seeded bf16 R-101
``ResNetFPN`` at 1024² for each pyramid: its ms and peak memory before (the
chain: gradients on, F.conv2d's bias and each op apart) and after (the
pass), in turns, and the pass's device ms in one profiled call. Prints one
JSON line with the card's name and power limit; each site also on stderr.

    python3 tools/torch_conv_epilogue_time.py [BATCH]

Needs a CUDA card.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch_kernel_cases import PEAK_BYTES, epilogue_case, epilogue_sites, seeded_fpn  # noqa: E402

from objectdetection_torch.models import backbone as bb  # noqa: E402
from objectdetection_torch.ops import conv_epilogue as ce  # noqa: E402
from objectdetection_torch.probes import common  # noqa: E402

REPS = 5


def same(a, b) -> bool:
    """Bit-equal values with NaNs in the same places."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(a[~nan_a], b[~nan_b])


def pyramid(levels) -> str:
    return f"P{levels[0]}-P{levels[-1]}"


def sites(batch, dev):
    """Each site's row and the sums over one call of each pyramid."""
    gen = torch.Generator(device=dev).manual_seed(15)
    rows, totals = {}, {pyramid(lv): [0.0, 0.0, 0.0] for lv in (bb.P2_P6, bb.P3_P7)}
    for site, calls in epilogue_sites(batch).values():
        case = epilogue_case(site, torch.bfloat16, dev, gen, vec_dtype=torch.bfloat16)
        want = ce.conv_epilogue_plain(case[0].clone(), *case[1:])
        if not same(ce.conv_epilogue(*case), want):
            raise SystemExit(f"conv_epilogue {site[0]} B={batch} {site[5]}: kernel differs "
                             "from plain")
        del want
        row = {"kernel_ms": common.timed(lambda: ce.conv_epilogue(*case), REPS, dev)[0],
               "plain_ms": common.timed(lambda: ce.conv_epilogue_plain(*case), REPS, dev)[0],
               "bound_ms": ce.site_bytes(site) / PEAK_BYTES * 1e3,
               "calls": {pyramid(lv): n for lv, n in calls.items()}}
        row["byte_bound_pct"] = 100 * row["bound_ms"] / row["kernel_ms"]
        name = f"{site[0]} {site[3]}x{site[4]}x{site[2]} {site[5]}"
        rows[name] = row
        print(f"{name}: {json.dumps(row)}", file=sys.stderr, flush=True)
        if row["byte_bound_pct"] > 105:  # faster than HBM allows: the bytes or the time are wrong
            raise SystemExit(f"{name}: {row['byte_bound_pct']:.1f}% of the byte bound")
        for lv, n in row["calls"].items():
            for j, key in enumerate(("kernel_ms", "plain_ms", "bound_ms")):
                totals[lv][j] += n * row[key]
        del case
    return rows, {lv: dict(zip(("kernel_ms", "plain_ms", "bound_ms"), t))
                  for lv, t in totals.items()}


def backbone(batch, dev):
    """The whole bf16 ResNetFPN before and after the pass, each pyramid."""
    gen = torch.Generator(device=dev).manual_seed(16)
    x = (20 * torch.randn(batch, 3, 1024, 1024, device=dev, generator=gen)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    out = {}
    for levels in (bb.P2_P6, bb.P3_P7):
        fpn = seeded_fpn(levels, dev)
        call = lambda: fpn(x)
        ms, peak = {"chain": [], "pass": []}, {}
        for name in ("chain", "pass", "pass", "chain"):
            with torch.enable_grad() if name == "chain" else torch.inference_mode():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms[name].append(common.timed(call, 2, dev)[0])
                peak[name] = torch.cuda.max_memory_allocated()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.inference_mode(), torch.profiler.profile(activities=acts,
                                                             acc_events=True) as prof:
            call()
            torch.cuda.synchronize()
        split = common.per_call_ms(prof, 1)
        out[pyramid(levels)] = {
            "chain_ms": ms["chain"], "pass_ms": ms["pass"], "peak_bytes": peak,
            "profiled pass ms": sum(v for k, v in split.items() if "conv_epilogue" in k),
            "profiled device ms": sum(split.values())}
        del fpn
    return out


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    dev = torch.device("cuda", 0)
    rows, per_call = sites(batch, dev)
    print(json.dumps({"card": common.card(), "batch": batch, "per_call": per_call,
                      "backbone": backbone(batch, dev), "sites": rows}))


if __name__ == "__main__":
    main()
