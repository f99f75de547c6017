#!/usr/bin/env python3
"""Where a request to the port's float server spends its time, on one card.

    python3 tools/torch_serve_time.py [--reps 5]

Starts ``serve`` at COCO_CONFIG (R101 1024², seeded init weights cast to
bf16 once) and, for the three source images of ``chip_smoke.py`` phase 9
(480×640, 1200×900, 333×500, seeded), sent as PNG with the row filters
libpng chooses (``encode_png``'s default; ``filters`` counts the
rows of each kind 0-4), times on the host clock (median of ``--reps``;
every device call ends in ``torch.cuda.synchronize``):

- ``decode_numpy_ms`` / ``decode_native_ms``: ``image_io.decode_image`` of
  the PNG with the numpy row unfilter and with the C one
  (``csrc/png_unfilter.cu``, what the server uses on the card);
  ``decode_pillow_png_ms``: the C one on Pillow's PNG of the same image,
  where Pillow imports (else null);
- ``mold_ms`` / ``mold_new_thread_ms``: ``mold_image_host`` in the main
  thread and each in a new thread;
- ``detect_main_ms``: ``serve.detect`` (inference at batch one, unmold to
  the image's pixels) called in the main thread;
- ``detect_new_thread_ms``: the same call, each in a new thread (as
  ``ThreadingHTTPServer`` runs each request);
- ``detect_worker_ms``: the same call on ``serve.inference_worker()``, the
  one long-lived thread the server runs it on;
- ``handler_new_thread_ms``: the handler's timed body without HTTP, in a
  new thread: mold there, then ``detect`` on the worker;
- ``latency_ms`` / ``wall_ms``: the server's ``latency_ms`` (the same body)
  and the client's wall around ``POST /detect`` (also the body's upload
  and decode);
- ``busy_main_ms`` / ``busy_new_thread_ms``: device time of one call under
  ``torch.profiler``, main thread and new thread.

The mold, detect, handler and request cases run in ``--reps`` rounds, one
of each a round, so that a slow spell of the shared host hits them all;
``reps`` keeps every round's times.

Prints one JSON line with the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((480, 640), (1200, 900), (333, 500))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/torch_serve_time.py needs a CUDA card")
    from objectdetection_torch import serve
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.data import image_io
    from objectdetection_torch.data.preprocess import mold_image_host

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    server = serve.serve(config=COCO_CONFIG, port=0, block=False)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/detect"
    infer, params = server.infer_fn, server.variables
    worker = serve.inference_worker()

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def in_new_thread(fn):
        box = {}
        t = threading.Thread(target=lambda: box.update(r=timed(fn)))
        t.start()
        t.join()
        return box["r"]

    def on_worker(fn):
        return worker.submit(timed, fn).result()

    def busy(runner, fn):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            runner(fn)
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3

    def filter_counts(png):
        return np.bincount(image_io.png_row_filters(png), minlength=5).tolist()

    try:
        from PIL import Image
    except ImportError:
        Image = None
    rng = np.random.RandomState(9)
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in SHAPES]
    med = statistics.median
    rows = []
    try:
        for img in images:
            png = image_io.encode_png(img)
            rec = {"shape": list(img.shape[:2]), "png_bytes": len(png),
                   "filters": filter_counts(png)}
            for name, native in (("numpy", False), ("native", True)):
                got = image_io.decode_image(png, native=native)
                assert np.array_equal(got, img), f"decode ({name}) is not bit-exact"
                rec[f"decode_{name}_ms"] = med([
                    timed(lambda: image_io.decode_image(png, native=native))[1]
                    for _ in range(args.reps)])
            rec["decode_pillow_png_ms"] = None
            if Image is not None:
                f = io.BytesIO()
                Image.fromarray(img).save(f, "PNG")
                pil = f.getvalue()
                assert np.array_equal(image_io.decode_image(pil, native=True), img)
                rec["pillow_filters"] = filter_counts(pil)
                rec["decode_pillow_png_ms"] = med([
                    timed(lambda: image_io.decode_image(pil, native=True))[1]
                    for _ in range(args.reps)])
            molded, window, _ = mold_image_host(img, COCO_CONFIG)
            call = lambda: serve.detect(infer, params, molded, window, img.shape[:2],
                                        COCO_CONFIG)
            mold = lambda: mold_image_host(img, COCO_CONFIG)

            def handler_body():  # what the handler times as latency_ms, without HTTP
                m, win, _ = mold_image_host(img, COCO_CONFIG)
                return worker.submit(serve.detect, infer, params, m, win, img.shape[:2],
                                     COCO_CONFIG).result()

            cases = {"mold_ms": (timed, mold), "mold_new_thread_ms": (in_new_thread, mold),
                     "detect_main_ms": (timed, call),
                     "detect_new_thread_ms": (in_new_thread, call),
                     "detect_worker_ms": (on_worker, call),
                     "handler_new_thread_ms": (in_new_thread, handler_body)}
            reps = {k: [] for k in (*cases, "latency_ms", "wall_ms")}
            for runner, fn in cases.values():
                runner(fn)  # warm this runner
            for _ in range(args.reps):  # in rounds, so that a slow spell hits every case
                for k, (runner, fn) in cases.items():
                    reps[k].append(runner(fn)[1])
                t0 = time.perf_counter()
                req = urllib.request.Request(url, data=png, method="POST")
                with urllib.request.urlopen(req, timeout=300) as r:
                    reps["latency_ms"].append(json.loads(r.read())["latency_ms"])
                reps["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            rec.update({k: med(v) for k, v in reps.items()})
            rec["busy_main_ms"] = busy(timed, call)
            rec["busy_new_thread_ms"] = busy(in_new_thread, call)
            rec["reps"] = reps
            rows.append(rec)
    finally:
        worker.shutdown()
        server.shutdown()
        server.server_close()
        server.worker.shutdown()
    print(json.dumps({"card": card, "reps": args.reps, "pillow": Image is not None,
                      "images": rows}), flush=True)


if __name__ == "__main__":
    main()
