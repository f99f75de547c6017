"""Device time of the port's ROIAlign kernels in one checkout, split by kernel.

Times, at the COCO pyramid (B = 2, C = 256), with torch.profiler:

- ``batched_multilevel_roi_align`` in bf16 and f32 at the serving stages
  (box: 1000 ROIs, 7x7; mask: 100 ROIs, 14x14);
- ``roi_align_backward`` in bf16 at the training stages (200 ROIs per
  image, 7x7 and 14x14);
- the int8 epilogues at the serving stages: int8 in per channel -> int8
  out, bf16 in -> int8 out, int8 in per tensor -> int8 out, int8 in per
  channel -> bf16 out;

the boxes from ``tools/torch_kernel_cases.py`` (``roi_boxes``), and prints
one line of JSON: each case's device ms per call, its split by kernel (the
gradient's marks, zeroing, adds and finalize apart; the parent design's
zeroed f32 pyramid and cast show as PyTorch's fill and copy kernels), the
sums that PERF.md's rows use (``B1 bf16``, ``B1' bf16``, ``B1 int8``: box +
mask), each with the plain version's ms (CUDA events) and its bound (the
rows the samples touch read once, the output written once, at 3.35 TB/s;
or the blend's operations), the card's name and power limit, and for each
forward case a digest of its output bytes, so that two checkouts' outputs
can be held equal. The inputs come from this checkout's tools, the kernels
from the checkout at ROOT (default: this repository), so two versions of the
kernels are compared on one card, on the same inputs, by running this
script on each in turns, in one command:

    for r in OLD . . OLD; do python3 tools/torch_roi_align_time.py $r; done

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
import torch_kernel_cases as kc  # noqa: E402

from objectdetection_torch.config import COCO_CONFIG as cfg  # noqa: E402
from objectdetection_torch.ops import roi_align  # noqa: E402
from objectdetection_torch.probes import common  # noqa: E402


def by_kernel(fn, reps: int):
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.removeprefix("void ")[:60]
            split[name] = split.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    if not split:
        raise RuntimeError("the profiler saw no device time")
    return split


def cases(dev):
    """(name, fn, reps, plain fn, bound ms) of every timed call (the plain
    version and the bound for the three the sums use), inputs drawn from
    seeded generators."""
    from objectdetection_torch import quant

    gen = torch.Generator().manual_seed(2)
    image = tuple(cfg.image_shape[:2])
    c = cfg.fpn_channels
    f32 = [torch.randn(kc.BATCH, h, w, c, generator=gen).to(dev)
           for h, w in cfg.feature_shapes()[:4]]
    f16 = [f.to(torch.bfloat16) for f in f32]
    shapes = [tuple(f.shape) for f in f16]
    s_ch = (torch.rand(c, generator=gen) * 2 + 3.0).to(dev)
    s_sc = torch.tensor(4.5, device=dev)
    q_ch = [quant.quantize_act(f, s_ch) for f in f32]
    q_sc = [quant.quantize_act(f, s_sc) for f in f32]
    out = []
    for name, r, crop in (("box", 1000, cfg.pool_shape), ("mask", 100, cfg.mask_pool_shape)):
        boxes = kc.roi_boxes(gen, r, dev)
        train_boxes = kc.roi_boxes(gen, cfg.train_rois_per_image, dev)
        g = torch.randn(kc.BATCH, cfg.train_rois_per_image, *crop, c,
                        generator=gen).to(dev, torch.bfloat16)
        s_out = (torch.rand(*crop, c, generator=gen) * 2 + 3.0).to(dev)

        def align(feats, bx=boxes, cr=crop, fn=roi_align.batched_multilevel_roi_align, **kw):
            return lambda: fn(feats, bx, image, cr, **kw)

        plain = roi_align.batched_multilevel_roi_align_plain
        outs = kc.BATCH * r * crop[0] * crop[1] * c
        # bytes: the rows the samples touch (C values each), the boxes, the output
        rows = lambda feats: roi_align.touched_rows(feats, boxes, image, crop)
        bf16_bound = max((rows(f16) * c * 2 + boxes.numel() * 4 + outs * 2) / kc.PEAK_BYTES,
                         outs * 7 / kc.PEAK_BF16) * 1e3  # 4 products + 3 sums an output
        int8_bound = max((rows(q_ch) * c + boxes.numel() * 4 + outs + s_out.numel() * 4)
                         / kc.PEAK_BYTES, outs * 8 / kc.PEAK_F32) * 1e3  # + 1 for the map
        dense = sum(f.numel() for f in f16)  # the bf16 pyramid gradient, written whole
        grad_bound = max((g.numel() * 2 + train_boxes.numel() * 4 + dense * 2) / kc.PEAK_BYTES,
                         g.numel() * 8 / kc.PEAK_BF16) * 1e3
        out += [
            (f"{name} bf16", align(f16), 50, align(f16, fn=plain), bf16_bound),
            (f"{name} f32", align(f32), 50, None, None),
            (f"{name} grad bf16",
             lambda g=g, bx=train_boxes: roi_align.roi_align_backward(g, bx, shapes, image), 20,
             lambda g=g, bx=train_boxes: roi_align.roi_align_backward_plain(g, bx, shapes, image),
             grad_bound),
            (f"{name} int8 per channel -> int8", align(q_ch, out_quant=s_out, in_scale=s_ch), 20,
             align(q_ch, fn=plain, out_quant=s_out, in_scale=s_ch), int8_bound),
            (f"{name} bf16 -> int8", align(f16, out_quant=s_out), 20, None, None),
            (f"{name} int8 per tensor -> int8", align(q_sc, out_quant=s_out, in_scale=s_sc), 20,
             None, None),
            (f"{name} int8 per channel -> bf16", align(q_ch, in_scale=s_ch), 20, None, None),
        ]
    return out


def main():
    dev = torch.device("cuda", 0)
    res = {}
    for name, fn, reps, plain, bound in cases(dev):
        split = by_kernel(fn, reps)
        res[name] = sum(split.values())
        res[f"{name} by kernel"] = split
        if "grad" not in name:
            got = fn()
            res[f"{name} digest"] = hashlib.sha1(got.cpu().view(torch.uint8).numpy()).hexdigest()
        if plain is not None:
            res[f"{name} plain ms"] = common.timed(plain, 3, dev)[0]
            res[f"{name} bound ms"] = bound
    sums = {"B1 bf16": "bf16", "B1' bf16": "grad bf16", "B1 int8": "int8 per channel -> int8"}
    totals = {}
    for k, v in sums.items():
        for what, suffix in ((k, ""), (f"{k} plain ms", " plain ms"),
                             (f"{k} bound ms", " bound ms")):
            totals[what] = res[f"box {v}{suffix}"] + res[f"mask {v}{suffix}"]
    print(json.dumps({"root": ROOT, "card": common.card(), **totals, **res}))


if __name__ == "__main__":
    main()
