"""The port's HTTP server against the JAX package's.

- JAX's five ``tests/test_serve.py`` cases, run on the port's handler with
  the same stubbed inference (health, a JPEG round trip through Pillow,
  garbage and empty bodies answered 400, a wrong path 404), plus a PNG and
  a PPM round trip through the port's own decoders.
- The same PPM and PNG bytes through JAX's ``build_handler`` and the port's,
  at the small f32 config (R50, 64², ``detection_min_threshold=0``) with
  weights converted from JAX's: the same detections JSON (``latency_ms``
  aside). Scores at these weights are untied, so the top-k keeps the same
  rows in both; boxes are integers and scores rounded to 4 decimals, so
  the ~1e-6 float gap of the two frameworks does not show.
- Concurrent requests (two threads, three requests each, started together)
  equal sequential ones: the handler's one inference worker thread keeps
  one request at a time in ``functional_call``, which swaps tensors into a
  module shared per config; inference and unmold both run on that thread.
- ``serve``: the cast to bf16 and the warm-up (its answer equals a direct
  call on the cast state dict), a stale int8 artifact refused, and the
  per-channel sniff of an artifact without ``quant_meta.json``. Serving a
  quantized artifact end to end is in tests/test_torch_cli.py.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from objectdetection_tpu import detector as jdet
from objectdetection_tpu import serve as jserve
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES

from objectdetection_torch import serve as tserve
from objectdetection_torch.config import DetectorConfig
from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.convert import flax_to_state_dict
from objectdetection_torch.data import image_io
from objectdetection_torch.detector import Detections, make_infer_fn

torch.set_num_threads(1)

NAMES = ["bg", "a", "b", "c"]
STUB_CFG = DetectorConfig(image_shape=(128, 128, 3), image_min_dim=100, image_max_dim=128,
                          num_classes=4)
SMALL = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
             pre_nms_rois_count=128, post_nms_rois_training=48, post_nms_rois_inference=32,
             train_rois_per_image=8, rpn_train_anchors_per_image=32, max_gt_objects=4,
             compute_dtype="float32", detection_min_threshold=0.0)
JCFG, TCFG = J_SHAPES.replace(**SMALL), T_SHAPES.replace(**SMALL)


def start(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def post(url, body):
    req = urllib.request.Request(f"{url}/detect", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def fake_infer(variables, images, windows):
    """One confident detection covering the middle of the window."""
    n = STUB_CFG.detection_post_nms_instances
    boxes = torch.zeros((1, n, 4))
    boxes[0, 0] = torch.tensor([0.2, 0.2, 0.6, 0.6])
    cls = torch.zeros((1, n), dtype=torch.int32)
    cls[0, 0] = 2
    scores = torch.zeros((1, n))
    scores[0, 0] = 0.91
    return Detections(boxes=boxes, class_ids=cls, scores=scores, valid=scores > 0, masks=None)


@pytest.fixture(scope="module")
def stub_server():
    srv, url = start(tserve.build_handler(fake_infer, {}, STUB_CFG, NAMES))
    yield url
    srv.shutdown()


def test_healthz(stub_server):
    with urllib.request.urlopen(f"{stub_server}/healthz") as r:
        assert json.loads(r.read()) == {"status": "ok"}


@pytest.mark.parametrize("fmt", ["jpg", "png", "ppm"])
def test_detect_roundtrip(stub_server, fmt):
    img = (np.random.RandomState(0).rand(96, 120, 3) * 255).astype(np.uint8)
    if fmt == "jpg":
        pytest.importorskip("PIL.Image")
        import cv2  # the JAX test's encoder

        body = cv2.imencode(".jpg", img)[1].tobytes()
    else:
        body = image_io.encode_png(img) if fmt == "png" else image_io.encode_ppm(img)
    out = post(stub_server, body)
    assert len(out["detections"]) == 1
    d = out["detections"][0]
    assert d["class_name"] == "b" and d["score"] == 0.91
    y1, x1, y2, x2 = d["box_yxyx"]
    assert 0 <= y1 < y2 <= 96 and 0 <= x1 < x2 <= 120


@pytest.mark.parametrize("body", [b"not an image", b""])
def test_bad_body_400(stub_server, body):
    req = urllib.request.Request(f"{stub_server}/detect", data=body, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400
    payload = json.loads(e.value.read())
    assert payload["error"] in ("could not decode image", "missing or oversized body")


def test_every_device_call_of_a_request_runs_on_the_worker(monkeypatch):
    # inference and unmold (the only torch calls of a request) run on the
    # handler's worker thread, never on the request's own
    from objectdetection_torch.data import preprocess

    threads = []
    unmold = preprocess.unmold_detections

    def spy_unmold(*args):
        threads.append(("unmold", threading.current_thread().name))
        return unmold(*args)

    def spy_infer(*args):
        threads.append(("infer", threading.current_thread().name))
        return fake_infer(*args)

    monkeypatch.setattr(preprocess, "unmold_detections", spy_unmold)
    srv, url = start(tserve.build_handler(spy_infer, {}, STUB_CFG, NAMES))
    try:
        img = (np.random.RandomState(1).rand(96, 120, 3) * 255).astype(np.uint8)
        for _ in range(2):
            assert len(post(url, image_io.encode_png(img))["detections"]) == 1
    finally:
        srv.shutdown()
    assert [k for k, _ in threads] == ["infer", "unmold"] * 2
    assert all(name.startswith("inference") for _, name in threads), threads


def test_wrong_path_404(stub_server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{stub_server}/nope")
    assert e.value.code == 404


@pytest.fixture(scope="module")
def weights():
    variables = jax.tree.map(np.asarray, jdet.init_variables(JCFG, jax.random.PRNGKey(42)))
    return variables, flax_to_state_dict(variables)


@pytest.fixture(scope="module")
def model_servers(weights):
    variables, params = weights
    jsrv, jurl = start(jserve.build_handler(jdet.make_infer_fn(JCFG, with_masks=False),
                                            variables, JCFG, NAMES))
    tinfer = make_infer_fn(TCFG, with_masks=False, device="cpu")
    tsrv, turl = start(tserve.build_handler(tinfer, params, TCFG, NAMES))
    yield jurl, turl, (tinfer, params)
    jsrv.shutdown()
    tsrv.shutdown()


def request_images():
    rng = np.random.RandomState(11)
    yy, xx = np.mgrid[:48, :80]
    out = []
    for _ in range(3):
        img = rng.randint(0, 256, (48, 80, 3)).astype(np.float32)
        for _ in range(3):  # blobs, so that the heads see structure
            cy, cx, r = rng.uniform(8, 40), rng.uniform(8, 72), rng.uniform(4, 12)
            img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
        out.append(img.astype(np.uint8))
    return out


def detections(payload):
    assert set(payload) == {"latency_ms", "detections"}
    return payload["detections"]


@pytest.mark.parametrize("fmt", ["ppm", "png"])
def test_same_bytes_same_detections_as_jax(model_servers, fmt):
    jurl, turl, _ = model_servers
    enc = image_io.encode_ppm if fmt == "ppm" else image_io.encode_png
    for img in request_images()[:2]:
        body = enc(img)
        want, got = detections(post(jurl, body)), detections(post(turl, body))
        assert len(want) > 0
        assert got == want


def test_concurrent_requests_equal_sequential(model_servers):
    _, turl, _ = model_servers
    bodies = [image_io.encode_png(img) for img in request_images()]
    sequential = [detections(post(turl, b)) for b in bodies]
    results, errors = {}, []
    go = threading.Barrier(2)

    def client(t):
        go.wait()
        for i, b in enumerate(bodies):
            try:
                results[t, i] = detections(post(turl, b))
            except Exception as exc:  # recorded: the assertion below names it
                errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for t in range(2):
        for i in range(len(bodies)):
            assert results[t, i] == sequential[i]


def serve_once(body, **kw):
    srv = tserve.serve(config=TCFG, port=0, block=False, class_names=NAMES, device="cpu", **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        assert srv.warmup_seconds > 0
        return detections(post(f"http://127.0.0.1:{srv.server_address[1]}", body))
    finally:
        srv.shutdown()
        srv.server_close()


def direct(infer, params, img, cfg):
    """The same request through infer_fn and unmold_detections, called directly."""
    from objectdetection_torch.data.preprocess import mold_image_host, unmold_detections

    molded, window, _ = mold_image_host(img, cfg)
    det = infer(params, molded[None], window[None].astype(np.float32))
    rows = torch.cat([det.boxes[0], det.class_ids[0][:, None].float(), det.scores[0][:, None]], 1)
    b, c, s, v = unmold_detections(rows, window.astype(np.float32), cfg.image_shape[:2],
                                   torch.tensor(img.shape[:2]))
    return [{"box_yxyx": [int(x) for x in b[i]], "class_id": int(c[i]),
             "class_name": NAMES[int(c[i])], "score": round(float(s[i]), 4)}
            for i in np.where(v.numpy())[0]]


def test_serve_casts_once_and_answers_as_a_direct_call():
    from objectdetection_torch.checkpoint import cast_params_for_inference
    from objectdetection_torch.convert import init_params

    img = request_images()[0]
    got = serve_once(image_io.encode_png(img))
    params = cast_params_for_inference(init_params(TCFG, torch.Generator().manual_seed(0), "cpu"))
    want = direct(make_infer_fn(TCFG, with_masks=False, device="cpu"), params, img, TCFG)
    assert len(want) > 0 and got == want


def test_serve_refuses_a_stale_artifact(tmp_path):
    # an artifact without the pooled-ROI scales of int8_pooled
    sd = {"fpn.resnet.conv1.weight": torch.zeros(64, 3, 7, 7, dtype=torch.int8)}
    (tmp_path / "stale").mkdir()
    torch.save(sd, tmp_path / "stale" / "variables.pt")
    with pytest.raises(ValueError, match="stale int8 artifact"):
        tserve.serve(config=TCFG, port=0, block=False, quantized=str(tmp_path / "stale"),
                     device="cpu")


def test_per_channel_sniff_reads_out_scale_shapes():
    per_tensor = {"a.out_scale": torch.ones(()), "a.act_scale": torch.ones(64)}
    assert not tserve._sniff_per_channel(per_tensor)
    assert tserve._sniff_per_channel({**per_tensor, "b.out_scale": torch.ones(256)})


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.serve(config=TCFG, port=0, block=False)


def test_a_tagged_jpeg_is_served_upright(model_servers, monkeypatch):
    # EXIF orientation 6 (a turn of 90 degrees clockwise): the server detects
    # on the upright image and unmolds at its shape, as for that image posted
    # untagged (PNG of the same pixels)
    pytest.importorskip("PIL.Image")
    import struct

    import cv2

    from objectdetection_torch.data import preprocess

    _, turl, _ = model_servers
    img = request_images()[0]  # 48 x 80
    jpeg = cv2.imencode(".jpg", img[..., ::-1].copy())[1].tobytes()
    tiff = b"II" + struct.pack("<HIH", 42, 8, 1) + struct.pack("<HHIHH", 0x0112, 3, 1, 6, 0) \
        + bytes(4)
    app1 = b"Exif\0\0" + tiff
    tagged = jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + jpeg[2:]
    upright = image_io.decode_image(tagged)
    assert upright.shape == (80, 48, 3)
    np.testing.assert_array_equal(upright, image_io.decode_image(jpeg).swapaxes(0, 1)[:, ::-1])

    image_hw = []
    unmold = preprocess.unmold_detections

    def spy(*args):
        image_hw.append(tuple(int(x) for x in args[3]))
        return unmold(*args)

    monkeypatch.setattr(preprocess, "unmold_detections", spy)
    got = detections(post(turl, tagged))
    want = detections(post(turl, image_io.encode_png(upright)))
    assert image_hw == [(80, 48), (80, 48)]
    assert len(want) > 0 and got == want
    assert all(y2 <= 80 and x2 <= 48 for _, _, y2, x2 in (d["box_yxyx"] for d in got))
