"""The port's CLI: ``quantize`` → ``serve``, and ``infer``, against JAX.

At the small f32 config (R50, 64², ``detection_min_threshold=0``) on the CPU:

- ``run_quantize`` (the ``quantize`` command's recipe: random pixel-scale
  images, chunks of 1, percentile 90, per-channel) writes an artifact that
  ``serve(quantized=..., device="cpu", block=False)`` answers with exactly
  the detections of the frozen state dict called directly; the same
  artifact without ``quant_meta.json`` serves the same answer through the
  per-channel sniff. The artifact's ``quant_meta.json`` equals JAX's for
  the config.
- ``run_infer`` on a PNG file against JAX's ``cmd_infer`` steps (its ``cv2``
  mold, ``infer_fn``, ``unmold_detections``) on the same pixels and
  converted weights: integer boxes, class ids and valid rows equal, scores
  and soft masks within 1e-4 (the inference parity's tolerance). The
  ``*_det.png`` it writes reads back with ``cv2.imread`` at the input's
  shape.
- ``main``: ``quantize`` keeps JAX's default ``--config shapes``, which
  raises naming ROADMAP A4, and refuses JAX's optimizer flags; the
  commands default to the card and raise without one.
"""

import json
import shutil
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu import checkpoint as jck
from objectdetection_tpu import detector as jdet
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES
from objectdetection_tpu.data.preprocess import mold_image_host as j_mold
from objectdetection_tpu.data.preprocess import unmold_detections as j_unmold

from objectdetection_torch import cli, serve
from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.convert import flax_to_state_dict
from objectdetection_torch.data import image_io
from objectdetection_torch.data.preprocess import mold_image_host, unmold_detections
from objectdetection_torch.detector import make_infer_fn

torch.set_num_threads(1)

NAMES = ["bg", "a", "b", "c"]
SMALL = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
             pre_nms_rois_count=128, post_nms_rois_training=48, post_nms_rois_inference=32,
             train_rois_per_image=8, rpn_train_anchors_per_image=32, max_gt_objects=4,
             compute_dtype="float32", detection_min_threshold=0.0)
JCFG, TCFG = J_SHAPES.replace(**SMALL), T_SHAPES.replace(**SMALL)


def image(seed=5, shape=(48, 80)):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, shape + (3,)).astype(np.float32)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for _ in range(3):
        cy, cx, r = rng.uniform(8, shape[0] - 8), rng.uniform(8, shape[1] - 8), rng.uniform(4, 12)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
    return img.astype(np.uint8)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("int8") / "art")
    qcfg = cli.quantize_config(TCFG)
    frozen = cli.run_quantize(path, qcfg, device="cpu", calib_images=2, batch_size=1,
                              percentile=90.0)
    return path, frozen, qcfg


def served(body, **kw):
    srv = serve.serve(config=TCFG, port=0, block=False, class_names=NAMES, device="cpu", **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/detect",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["detections"]
    finally:
        srv.shutdown()
        srv.server_close()


def direct(params, img, cfg):
    molded, window, _ = mold_image_host(img, cfg)
    det = make_infer_fn(cfg, with_masks=False, device="cpu")(
        params, molded[None], window[None].astype(np.float32))
    rows = torch.cat([det.boxes[0], det.class_ids[0][:, None].float(), det.scores[0][:, None]], 1)
    b, c, s, v = unmold_detections(rows, window.astype(np.float32), cfg.image_shape[:2],
                                   torch.tensor(img.shape[:2]))
    return [{"box_yxyx": [int(x) for x in b[i]], "class_id": int(c[i]),
             "class_name": NAMES[int(c[i])], "score": round(float(s[i]), 4)}
            for i in np.where(v.numpy())[0]]


def test_quantize_then_serve_answers_as_the_frozen_state(artifact, tmp_path):
    path, frozen, qcfg = artifact
    assert all(frozen[k].dtype == torch.int8 for k in frozen if k.endswith("conv1.weight")
               and "branch" in k)
    img = image()
    want = direct(frozen, img, qcfg)
    assert len(want) > 0
    body = image_io.encode_png(img)
    assert served(body, quantized=path) == want
    bare = tmp_path / "no_meta"
    shutil.copytree(path, bare)
    (bare / "quant_meta.json").unlink()
    assert served(body, quantized=str(bare)) == want


def test_quantize_meta_equals_jax(artifact, tmp_path):
    path, _, _ = artifact
    jcfg = JCFG.replace(quantized_inference=True, per_channel_acts=True)
    jck.save_quantized(str(tmp_path / "j"), {"quant": {"s": np.ones(1, np.float32)}}, jcfg)
    with open(f"{path}/quant_meta.json", "rb") as f:
        assert f.read() == (tmp_path / "j" / "quant_meta.json").read_bytes()


def test_infer_matches_jax_steps_and_writes_a_png(tmp_path):
    import cv2  # the test's oracle only

    variables = jax.tree.map(np.asarray, jdet.init_variables(JCFG, jax.random.PRNGKey(42)))
    img = image(seed=8, shape=(56, 72))
    path = tmp_path / "photo.png"
    path.write_bytes(image_io.encode_png(img))
    (res,) = cli.run_infer([str(path)], TCFG, device="cpu", class_names=NAMES,
                           params=flax_to_state_dict(variables))

    rgb = cv2.imread(str(path))[:, :, ::-1]
    molded, window, _ = j_mold(rgb, JCFG)
    det = jdet.make_infer_fn(JCFG, with_masks=True)(
        variables, jnp.asarray(molded[None]), jnp.asarray(window[None].astype(np.float32)))
    boxes, cls, scores, valid = (np.asarray(x) for x in j_unmold(
        jnp.concatenate([det.boxes[0], det.class_ids[0][:, None].astype(jnp.float32),
                         det.scores[0][:, None]], axis=1),
        jnp.asarray(window.astype(np.float32)), JCFG.image_shape[:2], jnp.asarray(rgb.shape[:2])))
    assert valid.sum() > 0
    np.testing.assert_array_equal(res["boxes"], boxes[valid])
    np.testing.assert_array_equal(res["class_ids"], cls[valid])
    np.testing.assert_allclose(res["scores"], scores[valid], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res["masks"], np.asarray(det.masks[0])[valid], rtol=1e-4,
                               atol=1e-4)
    drawn = cv2.imread(res["out"])
    assert drawn is not None and drawn.shape == img.shape
    assert res["out"] == str(tmp_path / "photo_det.png")


def test_main_quantize_shapes_waits_for_a4(tmp_path):
    with pytest.raises(SystemExit, match="A4"):
        cli.main(["quantize", "--out", str(tmp_path / "q")])


@pytest.mark.parametrize("flag", ["--train-steps", "--lr", "--lr-schedule"])
def test_main_quantize_refuses_jax_optimizer_flags(tmp_path, flag, capsys):
    # JAX reads them only to rebuild its checkpoint's optimizer state; a
    # port checkpoint carries its own, so the port takes no such flag
    with pytest.raises(SystemExit) as e:
        cli.main(["quantize", "--out", str(tmp_path / "q"), "--config", "coco", flag, "1"])
    assert e.value.code == 2 and flag in capsys.readouterr().err


def test_main_commands_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    path = tmp_path / "x.png"
    path.write_bytes(image_io.encode_png(image()))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["infer", str(path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve", "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["quantize", "--out", str(tmp_path / "q"), "--config", "coco"])
