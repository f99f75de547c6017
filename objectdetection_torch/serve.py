"""Minimal inference server (standard-library HTTP, JSON detections).

Port of ``objectdetection_tpu.serve``: POST an image, get boxes, classes and
scores back as JSON in the image's own pixels (the box path; masks are not
sent over HTTP). One request at a time runs on the device, batch of one
(batching across requests is a front end's concern).

    python -m objectdetection_torch.cli serve --port 8000 [--weights mask_rcnn_coco.h5]
    curl -s --data-binary @photo.png localhost:8000/detect

Two differences from the JAX server:

- every device call of a request (:func:`detect`: inference, unmold)
  runs on one worker thread, so one request at a time is on the device:
  ``forward_inference`` runs ``torch.func.functional_call`` on one module
  shared per config, which swaps tensors into it in place, so two threads
  may not be inside it at once (a jitted JAX function holds no such
  state). One long-lived thread also keeps the per-thread CUDA state warm:
  a call from a new thread, as ``ThreadingHTTPServer`` runs each request,
  took 144-183 ms of host time on an H100 where the worker took 44-50 ms
  (``tools/torch_serve_time.py``). Decoding and the host mold stay on the
  request threads;
- images are decoded by :mod:`objectdetection_torch.data.image_io` (PNG and
  binary PPM/PGM itself, other formats through Pillow where it imports)
  instead of ``cv2.imdecode``; on the card its PNG row unfilter is the C
  loop of ``csrc/png_unfilter.cu``.

Entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

MAX_BODY = 64 * 1024 * 1024


def inference_worker() -> ThreadPoolExecutor:
    """The one thread that runs a server's inference calls, in turn."""
    return ThreadPoolExecutor(max_workers=1, thread_name_prefix="inference")


def detect(infer_fn, variables, molded, window, image_hw, config):
    """One molded image through ``infer_fn`` at batch one, its detections
    mapped back to the source image's pixels by ``unmold_detections``. Returns
    the valid rows as numpy: boxes [N, 4] (y1, x1, y2, x2) integer pixels,
    class ids, scores, and the soft masks [N, mh, mw] of a ``with_masks``
    call (else None). The server runs it on its inference worker, so that
    no CUDA call runs on a request thread."""
    import numpy as np
    import torch

    from objectdetection_torch.data.preprocess import unmold_detections

    det = infer_fn(variables, molded[None], window[None].astype(np.float32))
    rows = torch.cat([det.boxes[0], det.class_ids[0][:, None].to(torch.float32),
                      det.scores[0][:, None]], dim=1)
    boxes, class_ids, scores, valid = (t.cpu().numpy() for t in unmold_detections(
        rows, window.astype(np.float32), config.image_shape[:2], torch.tensor(image_hw)))
    masks = det.masks[0].float().cpu().numpy()[valid] if det.masks is not None else None
    return boxes[valid], class_ids[valid], scores[valid], masks


def build_handler(infer_fn, variables, config, class_names, worker=None,
                  native_decode: bool = False):
    """A request handler class serving ``infer_fn(variables, images,
    windows)``; every :func:`detect` runs on ``worker`` (a new
    :func:`inference_worker` if None), one at a time. ``native_decode``
    undoes PNG row filters in C (``image_io.decode_image(native=True)``)."""
    from objectdetection_torch.data.image_io import ImageDecodeError, decode_image
    from objectdetection_torch.data.preprocess import mold_image_host

    worker = worker if worker is not None else inference_worker()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            else:
                self._json(404, {"error": "use POST /detect or GET /healthz"})

        def do_POST(self):
            if self.path != "/detect":
                self._json(404, {"error": "POST /detect"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length == 0 or length > MAX_BODY:
                self._json(400, {"error": "missing or oversized body"})
                return
            raw = self.rfile.read(length)
            try:
                rgb = decode_image(raw, native=native_decode)
            except ImageDecodeError as exc:
                self._json(400, {"error": "could not decode image", "reason": str(exc)})
                return

            t0 = time.time()
            molded, window, _ = mold_image_host(rgb, config)
            boxes, cls, scores, _ = worker.submit(detect, infer_fn, variables, molded, window,
                                                  rgb.shape[:2], config).result()

            def name(c):
                return class_names[c] if class_names and c < len(class_names) else str(c)

            out = {
                "latency_ms": round(1000 * (time.time() - t0), 1),
                "detections": [
                    {
                        "box_yxyx": [int(x) for x in boxes[i]],
                        "class_id": int(cls[i]),
                        "class_name": name(int(cls[i])),
                        "score": round(float(scores[i]), 4),
                    }
                    for i in range(len(scores))
                ],
            }
            self._json(200, out)

    return Handler


def _sniff_per_channel(variables) -> bool:
    """Per-channel activation scales in an artifact saved without its gates:
    any [C] ``out_scale``."""
    return any(k.rsplit(".", 1)[-1] == "out_scale" and v.dim() == 1
               for k, v in variables.items())


def serve(
    port: int = 8000,
    weights: Optional[str] = None,
    host: str = "127.0.0.1",
    config=None,
    class_names=None,
    block: bool = True,
    quantized: Optional[str] = None,
    device="cuda",
):
    """Start the HTTP inference server; returns it (serving already with
    ``block``, else for the caller to ``serve_forever``).

    Without ``quantized`` the weights are ``init_params`` seed 0, or a
    matterport h5 (``weights``), cast to bf16 once. ``quantized`` is the
    directory of an int8 artifact from ``cli quantize``
    (:func:`~objectdetection_torch.checkpoint.save_quantized`): its
    ``quant_meta.json`` restores the gates it was calibrated with. One
    warm-up call runs before the server accepts traffic; its seconds are
    the server's ``warmup_seconds``; its ``config``, ``infer_fn`` and
    ``variables`` are what it answers with, and ``worker`` the thread that
    runs the calls (``worker.shutdown()`` after ``server.shutdown()``).
    """
    import numpy as np
    import torch

    from objectdetection_torch import checkpoint, detector
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.convert import init_params, resolve_device
    from objectdetection_torch.data import image_io
    from objectdetection_torch.data.coco import COCO_CLASS_NAMES

    dev = resolve_device(device)
    cfg = config or COCO_CONFIG
    if class_names is None:
        class_names = COCO_CLASS_NAMES
    if quantized:
        variables = checkpoint.load_quantized(quantized)
        if "pooled_box_scale" not in variables:
            raise ValueError(
                f"stale int8 artifact {quantized}: missing the pooled-ROI scales of "
                "cfg.int8_pooled; regenerate it with `cli quantize`")
        meta = checkpoint.load_quant_meta(quantized)
        if meta is not None:
            # the artifact records the gates it was calibrated with (each
            # changes the state dict's layout)
            cfg = cfg.replace(
                quantized_inference=True,
                per_channel_acts=meta["per_channel_acts"],
                quantize_rpn=meta["quantize_rpn"],
                quantize_box_head=meta["quantize_box_head"],
                quantize_mask_head=meta["quantize_mask_head"],
                # absent in artifacts saved before the gate (default: quantized)
                quantize_fpn_p2=meta.get("quantize_fpn_p2", True),
            )
        else:
            # no gates saved: per-channel from [C] out_scale vectors, head
            # gates at their defaults
            cfg = cfg.replace(quantized_inference=True,
                              per_channel_acts=_sniff_per_channel(variables))
    else:
        variables = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        if weights:
            variables = checkpoint.load_matterport_h5(weights, variables)
        # serving is inference only: cast the weights to bf16 once
        variables = checkpoint.cast_params_for_inference(variables)
    variables = {k: v.to(dev) for k, v in variables.items()}
    infer_fn = detector.make_infer_fn(cfg, with_masks=False, device=dev)

    # warm up, on the thread that will serve, before accepting traffic
    worker = inference_worker()
    d = cfg.image_max_dim

    def warm_up():
        t0 = time.perf_counter()
        infer_fn(variables, torch.zeros((1, d, d, 3)),
                 torch.tensor([[0.0, 0.0, float(d), float(d)]]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    warmup = worker.submit(warm_up).result()
    native = dev.type == "cuda"
    if native:  # build and load the C row unfilter before the first request
        image_io.unfilter_native(np.zeros((1, 2), np.uint8), 1)
    handler = build_handler(infer_fn, variables, cfg, class_names, worker, native)
    server = ThreadingHTTPServer((host, port), handler)
    # what the server answers with, for callers that check it directly
    server.config, server.infer_fn, server.variables = cfg, infer_fn, variables
    server.worker = worker
    server.warmup_seconds = warmup
    print(f"serving on http://{host}:{server.server_address[1]} (POST /detect, GET /healthz; "
          f"warm-up {warmup:.2f} s)", flush=True)
    if block:
        server.serve_forever()
    return server
