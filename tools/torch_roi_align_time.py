"""Device time of the port's ROIAlign kernels in one checkout, split by kernel.

Times, at the COCO pyramid (B = 2, C = 256), with torch.profiler:

- ``batched_multilevel_roi_align`` in bf16 and f32 at the serving stages of
  ``chip_smoke.py`` phase 3 (box: 1000 ROIs, 7x7; mask: 100 ROIs, 14x14);
- ``roi_align_backward`` in bf16 at the training stages of phase 5 (200
  ROIs per image, 7x7 and 14x14);
- the int8 epilogues of phase 7b at the serving stages: int8 in per channel
  -> int8 out, bf16 in -> int8 out, int8 in per tensor -> int8 out, int8 in
  per channel -> bf16 out;

and prints one line of JSON: each case's device ms per call, its split by
kernel (the gradient's marks, zeroing, adds and finalize apart; the parent
design's zeroed f32 pyramid and cast show as PyTorch's fill and copy
kernels), the sums that PERF.md's rows use (``B1 bf16``, ``B1' bf16``,
``B1 int8``: box + mask), the card's name and power limit, and for each
forward case a digest of its output bytes, so that two checkouts' outputs
can be held equal. The inputs come from this checkout's ``chip_smoke.py``,
the kernels from the checkout at ROOT (default: this repository), so two
versions of the kernels are compared on one card, on the same inputs, by
running this script on each in turns, in one command:

    for r in OLD . . OLD; do python3 tools/torch_roi_align_time.py $r; done

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

from objectdetection_torch.config import COCO_CONFIG as cfg  # noqa: E402
from objectdetection_torch.ops import roi_align  # noqa: E402


def load_smoke():
    spec = importlib.util.spec_from_file_location("roi_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


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


def cases(smoke, dev):
    """(name, fn, reps) of every timed call, inputs drawn from seeded generators."""
    from objectdetection_torch import quant

    gen = torch.Generator().manual_seed(2)
    image = tuple(cfg.image_shape[:2])
    c = cfg.fpn_channels
    f32 = [torch.randn(smoke.BATCH, h, w, c, generator=gen).to(dev)
           for h, w in cfg.feature_shapes()[:4]]
    f16 = [f.to(torch.bfloat16) for f in f32]
    shapes = [tuple(f.shape) for f in f16]
    s_ch = (torch.rand(c, generator=gen) * 2 + 3.0).to(dev)
    s_sc = torch.tensor(4.5, device=dev)
    q_ch = [quant.quantize_act(f, s_ch) for f in f32]
    q_sc = [quant.quantize_act(f, s_sc) for f in f32]
    out = []
    for name, r, crop in (("box", 1000, cfg.pool_shape), ("mask", 100, cfg.mask_pool_shape)):
        boxes = smoke.roi_boxes(gen, r, dev)
        train_boxes = smoke.roi_boxes(gen, cfg.train_rois_per_image, dev)
        g = torch.randn(smoke.BATCH, cfg.train_rois_per_image, *crop, c,
                        generator=gen).to(dev, torch.bfloat16)
        s_out = (torch.rand(*crop, c, generator=gen) * 2 + 3.0).to(dev)

        def align(feats, bx=boxes, cr=crop, **kw):
            return lambda: roi_align.batched_multilevel_roi_align(feats, bx, image, cr, **kw)

        out += [
            (f"{name} bf16", align(f16), 50),
            (f"{name} f32", align(f32), 50),
            (f"{name} grad bf16",
             lambda g=g, bx=train_boxes: roi_align.roi_align_backward(g, bx, shapes, image), 20),
            (f"{name} int8 per channel -> int8", align(q_ch, out_quant=s_out, in_scale=s_ch), 20),
            (f"{name} bf16 -> int8", align(f16, out_quant=s_out), 20),
            (f"{name} int8 per tensor -> int8", align(q_sc, out_quant=s_out, in_scale=s_sc), 20),
            (f"{name} int8 per channel -> bf16", align(q_ch, in_scale=s_ch), 20),
        ]
    return out


def main():
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    res = {}
    for name, fn, reps in cases(load_smoke(), dev):
        split = by_kernel(fn, reps)
        res[name] = sum(split.values())
        res[f"{name} by kernel"] = split
        if "grad" not in name:
            got = fn()
            res[f"{name} digest"] = hashlib.sha1(got.cpu().view(torch.uint8).numpy()).hexdigest()
    sums = {"B1 bf16": "bf16", "B1' bf16": "grad bf16", "B1 int8": "int8 per channel -> int8"}
    totals = {k: res[f"box {v}"] + res[f"mask {v}"] for k, v in sums.items()}
    print(json.dumps({"root": ROOT, "card": card, **totals, **res}))


if __name__ == "__main__":
    main()
