"""Command-line interface of the port: the serving commands.

    python -m objectdetection_torch.cli infer IMAGE... [--weights H5] [--no-masks]
    python -m objectdetection_torch.cli quantize --out DIR --config coco [...]
    python -m objectdetection_torch.cli serve [--port 8000] [--quant DIR]

(or ``odtorch ...`` once the package is installed). The flags are those of
the JAX package's ``odtpu``, plus ``--device`` (default ``cuda``; the
commands raise without a card unless given ``--device cpu``), less
``quantize``'s ``--train-steps``, ``--lr`` and ``--lr-schedule``: JAX reads
them only to rebuild the optimizer state its checkpoint restore needs, and
a port checkpoint carries its own. Each command
is a function of a config and a device (:func:`run_infer`,
:func:`run_quantize`) wrapped by its ``cmd_*``, which fixes
``COCO_CONFIG`` as JAX's commands do; :func:`main` returns what the
command's function returns. ``demo``, ``train``, ``train-coco``,
``eval-coco`` and ``bench`` are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def run_infer(paths: List[str], config, device="cuda", weights: Optional[str] = None,
              with_masks: bool = True, class_names=None, params=None):
    """Detect objects in image files and write ``<name>_det.png`` beside
    each. ``params`` defaults to ``init_params`` seed 0 (or the h5
    ``weights``). Returns one dict per image read: ``path``, ``out``,
    ``boxes`` [N, 4] source pixels, ``class_ids``, ``scores`` and ``masks``
    ([N, mh, mw] soft masks, or None)."""
    import torch

    from objectdetection_torch import checkpoint, detector, viz
    from objectdetection_torch.convert import init_params, resolve_device
    from objectdetection_torch.data.coco import COCO_CLASS_NAMES
    from objectdetection_torch.data.image_io import ImageDecodeError, decode_image, encode_png
    from objectdetection_torch.data.preprocess import mold_image_host
    from objectdetection_torch.serve import detect

    dev = resolve_device(device)
    if class_names is None:
        class_names = COCO_CLASS_NAMES
    if params is None:
        params = init_params(config, torch.Generator().manual_seed(0), device="cpu")
        if weights:
            print(f"loading weights from {weights}", file=sys.stderr)
            params = checkpoint.load_matterport_h5(weights, params)
    params = {k: v.to(dev) for k, v in params.items()}
    infer = detector.make_infer_fn(config, with_masks=with_masks, device=dev)
    results = []
    for path in paths:
        try:
            with open(path, "rb") as f:
                rgb = decode_image(f.read(), native=dev.type == "cuda")
        except (OSError, ImageDecodeError) as exc:
            print(f"cannot read {path}: {exc}", file=sys.stderr)
            continue
        molded, window, _ = mold_image_host(rgb, config)
        boxes, class_ids, scores, masks = detect(infer, params, molded, window, rgb.shape[:2],
                                                 config)
        print(f"{path}: {len(scores)} detections")
        img = viz.draw_detections(rgb, boxes, class_ids, scores, class_names=class_names,
                                  masks=masks)
        out = path.rsplit(".", 1)[0] + "_det.png"
        with open(out, "wb") as f:
            f.write(encode_png(img))
        print(f"wrote {out}")
        results.append(dict(path=path, out=out, boxes=boxes, class_ids=class_ids,
                            scores=scores, masks=masks))
    return results


def quantize_config(base, per_channel: bool = True, post_nms: int = 0):
    """The quantized config ``quantize`` calibrates: ``base`` with
    ``quantized_inference`` and ``per_channel_acts``, and the post-NMS
    budget of a training run with ``post_nms``."""
    cfg = base.replace(quantized_inference=True, per_channel_acts=per_channel)
    if post_nms:
        cfg = cfg.replace(
            post_nms_rois_training=post_nms,
            post_nms_rois_inference=min(cfg.post_nms_rois_inference, post_nms),
            pre_nms_rois_count=min(cfg.pre_nms_rois_count, 8 * post_nms),
        )
    return cfg


def run_quantize(out: str, config, device="cuda", ckpt: Optional[str] = None,
                 weights: Optional[str] = None, calib_images: int = 64, batch_size: int = 4,
                 percentile: Optional[float] = 90.0, seed: int = 0):
    """Calibrate and freeze the int8 serving state of the quantized
    ``config`` and save it to ``out`` (with ``quant_meta.json``). The float
    weights are a port checkpoint (``ckpt``), or an h5 (``weights``), or
    ``init_params`` seed 0. Calibration runs on
    ``calib_images`` random pixel-scale images ``rand·255 − 128`` drawn from
    ``seed``, in chunks of ``batch_size``, at ``percentile`` (negative or
    None: running absmax). Returns the frozen state dict (on ``device``)."""
    import numpy as np
    import torch

    from objectdetection_torch import checkpoint, detector, quant
    from objectdetection_torch.convert import init_params, resolve_device

    dev = resolve_device(device)
    params = init_params(config, torch.Generator().manual_seed(0), device="cpu")
    if ckpt:
        # a train checkpoint of the float config: its params and batch_stats
        # fill the quantized state (the optimizer state is not needed to serve)
        like = detector.create_train_state(config.replace(quantized_inference=False),
                                           device="cpu")
        state = checkpoint.load_checkpoint(ckpt, like)
        print(f"restored step {state.step}", file=sys.stderr)
        params = {**params, **state.params, **state.batch_stats}
    elif weights:
        params = checkpoint.load_matterport_h5(weights, params)
    params = {k: v.to(dev) for k, v in params.items()}
    print("calibrating on random images (pass --ckpt or extend with a real calibration "
          "set for production scales)", file=sys.stderr)
    rng = np.random.RandomState(seed)
    h, w = config.image_shape[:2]
    images = rng.rand(calib_images, h, w, 3).astype(np.float32) * 255.0 - 128.0
    pct = None if percentile is None or percentile < 0 else percentile
    calibrated = quant.calibrate_variables(params, images, config,
                                           batch_size=batch_size or None,
                                           percentile=pct, device=dev)
    frozen = quant.freeze_weights(calibrated)
    checkpoint.save_quantized(out, frozen, config)
    print(f"int8 artifact saved to {out}")
    return frozen


def cmd_infer(args):
    from objectdetection_torch.config import COCO_CONFIG

    return run_infer(args.images, COCO_CONFIG, device=args.device,
                     weights=args.weights or None, with_masks=not args.no_masks)


def cmd_quantize(args):
    from objectdetection_torch.config import COCO_CONFIG

    if args.config == "shapes":
        raise SystemExit(
            "quantize --config shapes calibrates on the synthetic shapes dataset, which is "
            "not ported yet (ROADMAP A4); pass --config coco")
    cfg = quantize_config(COCO_CONFIG, args.per_channel, args.post_nms)
    return run_quantize(args.out, cfg, device=args.device, ckpt=args.ckpt or None,
                        weights=args.weights or None, calib_images=args.calib_images,
                        batch_size=args.batch_size, percentile=args.percentile, seed=args.seed)


def cmd_serve(args):
    from objectdetection_torch.serve import serve

    return serve(port=args.port, weights=args.weights or None, host=args.host,
                 quantized=args.quant or None, device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="odtorch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; raises without a card)")

    i = sub.add_parser("infer", help="detect objects in image files")
    i.add_argument("images", nargs="+")
    i.add_argument("--weights", default="", help="matterport mask_rcnn_coco.h5")
    i.add_argument("--no-masks", action="store_true")
    add_device(i)
    i.set_defaults(fn=cmd_infer)

    q = sub.add_parser("quantize", help="produce a persisted int8 serving artifact")
    q.add_argument("--out", required=True, help="artifact output dir")
    q.add_argument("--config", choices=["shapes", "coco"], default="shapes",
                   help="shapes waits for the shapes dataset (ROADMAP A4)")
    q.add_argument("--ckpt", default="", help="a train checkpoint saved by the port")
    q.add_argument("--weights", default="", help="matterport h5")
    q.add_argument("--calib-images", type=int, default=64)
    q.add_argument("--batch-size", type=int, default=4)
    q.add_argument("--percentile", type=float, default=90.0,
                   help="percentile of the per-chunk absmax (default 90; -1 for the "
                   "running absmax)")
    q.add_argument("--per-channel", dest="per_channel", action="store_true", default=True,
                   help="per-input-channel activation scales folded into the frozen "
                   "kernels (cfg.per_channel_acts, default)")
    q.add_argument("--no-per-channel", dest="per_channel", action="store_false")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--post-nms", type=int, default=0,
                   help="match the post-nms budget of the train run")
    add_device(q)
    q.set_defaults(fn=cmd_quantize)

    s = sub.add_parser("serve", help="HTTP inference server")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--weights", default="")
    s.add_argument("--quant", default="", help="int8 artifact dir from `quantize`")
    add_device(s)
    s.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
