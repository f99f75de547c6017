#!/usr/bin/env python3
"""Int8 PTQ accuracy of the port: float against int8 mAP on a trained shapes model.

    python -m objectdetection_torch.cli train --steps 3000 --batch 8 --dataset-size 1024 \\
        --masks --lr 0.003 --lr-schedule warmup_cosine --ckpt /tmp/shapes_ckpt
    python3 tools/torch_int8_accuracy.py --ckpt /tmp/shapes_ckpt [--per-channel --percentile 90]

The port of ``benchmarks/int8_accuracy.py``. It loads a checkpoint written
by the port's ``train --ckpt`` (``checkpoint.save_checkpoint``; JAX's orbax
directories are another format), evaluates the float state on ``--images``
held-out shapes images (seed ``--seed + 1000``), calibrates the int8 path
on ``--calib-images`` images (seed ``--seed + 2000``; chunks of 4, at
``--percentile``), freezes it (with ``--bias-corr``: records the input
means, freezes, folds the weight-quantization error into the biases) and
evaluates it on the same images, both through ``cli.evaluate_on_shapes``
at ``--score-threshold`` with masks.

Prints JSON with ``int8_accuracy.py``'s keys: ``float`` and ``int8`` →
``box_mAP@0.5`` and ``mask_mAP@0.5``, ``delta`` → ``box`` and ``mask``
(int8 − float at IoU 0.5). ``float`` and ``int8`` also hold
``box_mAP@[.5:.95]`` and ``mask_mAP@[.5:.95]`` (the COCO sweep of
``evaluate.coco_iou_thresholds``, from the same pass), since mAP@0.5
saturates on shapes.

Flags: ``int8_accuracy.py``'s, under their names and defaults, plus
``--device`` (default ``cuda``; without a card the tool raises unless
given ``--device cpu``). ``--train-steps``, ``--lr`` and ``--lr-schedule``
enter the config as in JAX (they must match the training run only there,
for its optimizer state); ``--approx-topk`` sets ``use_approx_topk``,
which the port reads as exact top-k.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True, help="checkpoint directory of the port's train --ckpt")
    p.add_argument("--images", type=int, default=64, help="held-out eval images")
    p.add_argument("--calib-images", type=int, default=16)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--score-threshold", type=float, default=0.5)
    p.add_argument("--percentile", type=float, default=None,
                   help="robust per-chunk-absmax percentile calibration (e.g. 90)")
    p.add_argument("--per-channel", action="store_true",
                   help="per-input-channel activation quantization (cfg.per_channel_acts) on "
                   "the backbone/FPN/RPN")
    p.add_argument("--float-rpn", action="store_true",
                   help="keep the RPN head in float (cfg.quantize_rpn=False)")
    p.add_argument("--float-box-head", action="store_true",
                   help="keep the box/class head in float (cfg.quantize_box_head=False)")
    p.add_argument("--float-mask-head", action="store_true",
                   help="keep the mask head in float (cfg.quantize_mask_head=False)")
    p.add_argument("--float-p2", action="store_true",
                   help="keep the finest FPN level in float (cfg.quantize_fpn_p2=False)")
    p.add_argument("--bias-corr", action="store_true",
                   help="PTQ bias correction: fold E[weight-quant error * x] into the conv "
                   "biases after freezing (quant.apply_bias_correction)")
    p.add_argument("--int8-stem", action="store_true",
                   help="serve conv1 int8 (cfg.int8_stem=True; the config's default is the "
                   "bf16 stem)")
    p.add_argument("--bf16-stages", default="",
                   help="comma list of ResNet stages served bf16 with dequantized int8 kernels "
                   "(cfg.bf16_stages), e.g. '2' or '2,3'")
    p.add_argument("--no-int8-pooled", dest="int8_pooled", action="store_false", default=True,
                   help="disable cfg.int8_pooled (int8 pooled ROI features into the heads)")
    p.add_argument("--no-int8-align-inputs", dest="int8_align_inputs", action="store_false",
                   default=True,
                   help="disable cfg.int8_align_inputs (ROIAlign reads the RPN's int8 "
                   "P-levels)")
    p.add_argument("--approx-topk", action="store_true",
                   help="sets cfg.use_approx_topk in both evaluations, which the port reads as "
                   "exact top-k")
    # the optimizer settings of the training run, as int8_accuracy.py puts
    # them into the config
    p.add_argument("--train-steps", type=int, default=3000)
    p.add_argument("--lr", type=float, default=0.003)
    p.add_argument("--lr-schedule", default="warmup_cosine")
    p.add_argument("--post-nms", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    return p


def float_config(args):
    """``SHAPES_CONFIG`` with the run's post-NMS budget and optimizer
    settings (``int8_accuracy.py:99-114``)."""
    from objectdetection_torch.config import SHAPES_CONFIG

    cfg = SHAPES_CONFIG.replace(
        post_nms_rois_training=args.post_nms,
        post_nms_rois_inference=min(SHAPES_CONFIG.post_nms_rois_inference, args.post_nms),
        pre_nms_rois_count=min(SHAPES_CONFIG.pre_nms_rois_count, 8 * args.post_nms),
        learning_rate=args.lr,
        lr_schedule=args.lr_schedule,
        warmup_steps=max(args.train_steps // 20, 10),
        total_train_steps=args.train_steps,
    )
    return cfg.replace(use_approx_topk=True) if args.approx_topk else cfg


def int8_config(cfg, args):
    """The quantized config the flags select (``int8_accuracy.py:127-140``)."""
    return cfg.replace(
        quantized_inference=True,
        quantize_rpn=not args.float_rpn,
        quantize_box_head=not args.float_box_head,
        quantize_mask_head=not args.float_mask_head,
        quantize_fpn_p2=not args.float_p2,
        per_channel_acts=args.per_channel,
        int8_stem=args.int8_stem,
        int8_pooled=args.int8_pooled,
        int8_align_inputs=args.int8_align_inputs,
        bf16_stages=tuple(int(s) for s in args.bf16_stages.split(",") if s),
    )


def int8_state(float_params, images, cfg_q, args, dev):
    """The frozen int8 state: the quantized config's seeded state dict
    (``init_params`` seed 0, for its scale buffers) under the trained float
    tensors, calibrated on ``images`` in chunks of 4 at ``--percentile``,
    then frozen, with ``--bias-corr`` after recording the input means."""
    import torch

    from objectdetection_torch import quant
    from objectdetection_torch.convert import init_params

    params = {**init_params(cfg_q, torch.Generator().manual_seed(0), device=dev),
              **float_params}
    calibrated = quant.calibrate_variables(params, images, cfg_q, batch_size=4,
                                           percentile=args.percentile, device=dev)
    if not args.bias_corr:
        return quant.freeze_weights(calibrated)
    means = quant.record_act_means(calibrated, images, cfg_q, batch_size=4, device=dev)
    return quant.apply_bias_correction(quant.freeze_weights(calibrated), calibrated, means)


def evaluate(params, cfg, ds, ids, args, dev):
    """Box and mask mAP at IoU 0.5 and over the COCO sweep, from one pass
    of ``cli.evaluate_on_shapes``."""
    from objectdetection_torch.cli import evaluate_on_shapes
    from objectdetection_torch.evaluate import coco_iou_thresholds

    res = evaluate_on_shapes(params, cfg, ds, ids, score_threshold=args.score_threshold,
                             with_masks=True, device=dev, iou_thresholds=coco_iou_thresholds())
    # AP50 is absent only where no class has ground truth, and mAP then 0
    return {"box_mAP@0.5": res.get("AP50", 0.0), "mask_mAP@0.5": res.get("mask_AP50", 0.0),
            "box_mAP@[.5:.95]": res["mAP"], "mask_mAP@[.5:.95]": res["mask_mAP"]}


def main(argv=None) -> dict:
    """Parse ``argv`` (default ``sys.argv[1:]``), evaluate, print the JSON
    and return it."""
    import torch

    from objectdetection_torch import checkpoint, detector
    from objectdetection_torch.convert import resolve_device
    from objectdetection_torch.data.shapes import ShapesDataset

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = float_config(args)
    like = detector.create_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    state = checkpoint.load_checkpoint(args.ckpt, like)
    print(f"restored step {state.step}", file=sys.stderr)
    float_params = {**state.params, **state.batch_stats}
    del like, state

    ds = ShapesDataset(args.images, 128, 128, seed=args.seed + 1000)
    calib_ds = ShapesDataset(args.calib_images, 128, 128, seed=args.seed + 2000)
    eval_ids = list(range(args.images))

    res_f = evaluate(float_params, cfg, ds, eval_ids, args, dev)
    cfg_q = int8_config(cfg, args)
    calib = calib_ds.load_batch(list(range(args.calib_images)), cfg_q, with_masks=False)
    qparams = int8_state(float_params, calib.images, cfg_q, args, dev)
    res_q = evaluate(qparams, cfg_q, ds, eval_ids, args, dev)

    out = {
        "float": res_f,
        "int8": res_q,
        "delta": {
            "box": res_q["box_mAP@0.5"] - res_f["box_mAP@0.5"],
            "mask": res_q["mask_mAP@0.5"] - res_f["mask_mAP@0.5"],
        },
    }
    print(json.dumps(out, indent=2, default=float), flush=True)
    return out


if __name__ == "__main__":
    main()
