"""The port's COCO reader, batches and evaluation loop against the JAX package's.

On a synthesized mini COCO (``instances_*.json`` layout, PNG images written
by the port's encoder; one JPEG), as tests/test_coco.py builds one:

- the cases of tests/test_coco.py through both readers: category mapping,
  xywh → yxyx boxes, crowd regions kept apart as ignore regions, images
  (PNG pixels identical to ``cv2.imread``'s; the JPEG checked for shape and
  decode only: Pillow's and cv2's IDCTs differ), ``masks`` None without
  ``pycocotools`` in both;
- ``train_batch`` and ``eval_batch`` against JAX's: images within 1e-3 on
  the 0-255 scale (the tolerance tests/test_torch_preprocess.py holds the
  host mold to: cv2 and the port's resize blend in other orders), windows,
  shapes, boxes and class ids equal; masks, monkeypatched into both
  packages, identical, as mini-masks and as full molded masks;
- ``run_coco_eval`` on e2e_small (R50, 64², f32) with JAX's weights, on
  ground truth drawn from the model's own detections (so that the mAP is
  not trivially 0) and a ragged last batch: the same mAP as JAX's within
  1e-6, and the same detection count for every image; the same through
  ``mesh=parallel.make_mesh()`` at a world of one (gloo), which hands the
  evaluator the same rows.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from objectdetection_tpu import coco_eval as jce
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES
from objectdetection_tpu.data import coco as jcoco

from objectdetection_torch import coco_eval as tce
from objectdetection_torch import parallel
from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.data import coco as tcoco
from objectdetection_torch.data.image_io import encode_png

torch.set_num_threads(1)

SIZES = [(96, 128), (80, 80), (50, 70), (64, 40)]
CATEGORIES = [dict(id=3, name="car"), dict(id=7, name="train"), dict(id=9, name="boat")]
SMALL = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
             pre_nms_rois_count=128, post_nms_rois_training=48, post_nms_rois_inference=32,
             train_rois_per_image=8, rpn_train_anchors_per_image=32, max_gt_objects=4,
             compute_dtype="float32", detection_min_threshold=0.0)


def write_images(img_dir):
    rng = np.random.RandomState(0)
    images = []
    for i, (h, w) in enumerate(SIZES):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        yy, xx = np.mgrid[:h, :w]
        for _ in range(3):  # a few flat discs, so that the model sees shapes
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(6, 20)
            img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
        (img_dir / f"img{i}.png").write_bytes(encode_png(img))
        images.append(dict(id=i + 1, file_name=f"img{i}.png", height=h, width=w))
    return images


def write_annotations(path, images, annotations):
    with open(path, "w") as f:
        json.dump(dict(images=images, annotations=annotations, categories=CATEGORIES), f)
    return str(path)


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    img_dir = root / "images"
    os.makedirs(img_dir)
    images = write_images(img_dir)
    import cv2  # the test's oracle only: one JPEG

    jpg = (np.random.RandomState(1).rand(40, 56, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(img_dir / "img9.jpg"), jpg)
    images.append(dict(id=10, file_name="img9.jpg", height=40, width=56))
    annotations = [
        dict(id=1, image_id=1, category_id=7, bbox=[10, 20, 30, 40], iscrowd=0),
        dict(id=2, image_id=1, category_id=3, bbox=[5, 5, 10, 10], iscrowd=0),
        dict(id=3, image_id=2, category_id=3, bbox=[0, 0, 50, 50], iscrowd=1),
        dict(id=4, image_id=3, category_id=9, bbox=[4, 6, 40, 30], iscrowd=0),
        dict(id=5, image_id=3, category_id=9, bbox=[30, 2, 0, 10], iscrowd=0),  # empty: dropped
        dict(id=6, image_id=4, category_id=7, bbox=[2.5, 3.5, 20.25, 30.75], iscrowd=0),
    ]
    return write_annotations(root / "instances.json", images, annotations), str(img_dir)


def both(mini_coco):
    return jcoco.CocoDataset(*mini_coco), tcoco.CocoDataset(*mini_coco)


def test_category_mapping_and_annotations_equal_jax(mini_coco):
    jds, tds = both(mini_coco)
    assert tds.class_names == jds.class_names == ["BG", "car", "train", "boat"]
    assert tds.num_classes == 4 and tds.image_ids == jds.image_ids
    for img_id in jds.image_ids:
        for fn in ("annotations", "crowd_regions"):
            for got, want in zip(getattr(tds, fn)(img_id), getattr(jds, fn)(img_id)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    boxes, ids = tds.annotations(1)
    np.testing.assert_allclose(boxes[0], [20, 10, 60, 40])  # xywh → y1x1y2x2
    assert ids[0] == 2  # category 7 → second class
    assert len(tds.annotations(2)[0]) == 0 and len(tds.crowd_regions(2)[0]) == 1
    assert len(tds.annotations(3)[0]) == 1  # the empty box is dropped
    assert tds.masks(1) is None and jds.masks(1) is None  # no pycocotools


def test_images_decode_as_cv2(mini_coco):
    jds, tds = both(mini_coco)
    for img_id in jds.image_ids[:-1]:
        got = tds.image(img_id)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jds.image(img_id))
    jpg = tds.image(10)  # Pillow's decode: shape only
    assert jpg.shape == (40, 56, 3) and jpg.dtype == np.uint8


def fake_masks(self, image_id):
    """Instance masks aligned with ``annotations``: an ellipse in each box."""
    info = self.image_info(image_id)
    h, w = info["height"], info["width"]
    boxes, _ = self.annotations(image_id)
    yy, xx = np.mgrid[:h, :w]
    out = np.zeros((h, w, len(boxes)), bool)
    for j, (y1, x1, y2, x2) in enumerate(boxes):
        cy, cx = (y1 + y2) / 2, (x1 + x2) / 2
        ry, rx = max((y2 - y1) / 2, 1), max((x2 - x1) / 2, 1)
        out[:, :, j] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    return out


@pytest.mark.parametrize("mini", [(28, 28), (14, 20), None])
def test_train_batch_matches_jax(mini_coco, monkeypatch, mini):
    monkeypatch.setattr(jcoco.CocoDataset, "masks", fake_masks)
    monkeypatch.setattr(tcoco.CocoDataset, "masks", fake_masks)
    jds, tds = both(mini_coco)
    over = dict(num_classes=4, max_gt_objects=4, use_mini_mask=mini is not None,
                mini_mask_shape=mini or (0, 0))
    jcfg, tcfg = J_SHAPES.replace(**over), T_SHAPES.replace(**over)
    ids = [1, 3, 4, 2]
    want = jcoco.train_batch(jds, ids, jcfg, with_masks=True)
    got = tcoco.train_batch(tds, ids, tcfg, with_masks=True)
    np.testing.assert_allclose(got.images, want.images, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.gt_boxes, want.gt_boxes)
    for f in ("gt_class_ids", "gt_masks", "active_class_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.gt_masks.sum() > 0
    # the case of tests/test_coco.py: image 1 is 96x128 → top pad 16
    np.testing.assert_allclose(got.gt_boxes[0, 0] * 127.0 + [0, 0, 1, 1], [36, 10, 76, 40],
                               atol=0.5)
    nomask = tcoco.train_batch(tds, ids, tcfg, with_masks=False)
    assert nomask.gt_masks is None


def test_eval_batch_matches_jax(mini_coco):
    jds, tds = both(mini_coco)
    ids = [1, 2, 3, 4]
    want = jcoco.eval_batch(jds, ids, J_SHAPES)
    got = tcoco.eval_batch(tds, ids, T_SHAPES)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], [list(s) for s in SIZES])


class Recorder:
    """DetectionEvaluator that keeps what each image gave it."""

    def __init__(self, base, rows):
        self.base, self.rows = base, rows

    def __call__(self, *a, **kw):
        ev = self.base(*a, **kw)
        add = ev.add_image

        def add_image(*args, **kwargs):
            self.rows.append([np.asarray(x) for x in args[:3]])
            return add(*args, **kwargs)

        ev.add_image = add_image
        return ev


@pytest.fixture(scope="module")
def jax_variables():
    import jax

    from objectdetection_tpu import detector as jdet

    return jax.tree.map(np.asarray, jdet.init_variables(J_SHAPES.replace(**SMALL),
                                                        jax.random.PRNGKey(5)))


def test_run_coco_eval_matches_jax(mini_coco, jax_variables, tmp_path, monkeypatch):
    import jax

    from objectdetection_torch.convert import flax_to_state_dict

    jcfg, tcfg = J_SHAPES.replace(**SMALL), T_SHAPES.replace(**SMALL)
    params = flax_to_state_dict(jax_variables)
    ann_file, img_dir = mini_coco
    with open(ann_file) as f:
        data = json.load(f)
    data["images"] = data["images"][:-1]  # the PNGs only
    data["annotations"] = [a for a in data["annotations"] if a["image_id"] <= len(SIZES)]
    first = write_annotations(tmp_path / "first.json", data["images"], data["annotations"])

    # ground truth from the model's own detections: each image's two best
    rows = []
    monkeypatch.setattr(tce, "DetectionEvaluator", Recorder(tce.DetectionEvaluator, rows))
    tce.run_coco_eval(tcoco.CocoDataset(first, img_dir), params, tcfg, batch_size=3,
                      verbose=False, device="cpu")
    anns, k = [], 100
    for info, (boxes, cls, scores) in zip(data["images"], rows):
        for j in np.argsort(-scores)[:2]:
            y1, x1, y2, x2 = (float(v) for v in boxes[j])
            anns.append(dict(id=k, image_id=info["id"], category_id=CATEGORIES[cls[j] - 1]["id"],
                             bbox=[x1, y1, x2 - x1, y2 - y1], iscrowd=0))
            k += 1
    anns.append(dict(id=k, image_id=2, category_id=3, bbox=[0, 0, 40, 40], iscrowd=1))
    second = write_annotations(tmp_path / "second.json", data["images"], anns)

    jrows, trows = [], []
    monkeypatch.setattr(tce, "DetectionEvaluator", Recorder(tce.DetectionEvaluator.base, trows))
    monkeypatch.setattr(jce, "DetectionEvaluator", Recorder(jce.DetectionEvaluator, jrows))
    tres, tips = tce.run_coco_eval(tcoco.CocoDataset(second, img_dir), params, tcfg,
                                   batch_size=3, verbose=False, device="cpu")
    jres, _ = jce.run_coco_eval(jcoco.CocoDataset(second, img_dir),
                                jax.tree.map(np.asarray, jax_variables), jcfg, batch_size=3,
                                verbose=False)
    assert [len(r[0]) for r in trows] == [len(r[0]) for r in jrows]
    assert sum(len(r[0]) for r in trows) > 0 and tips > 0
    assert tres["mAP"] > 0.1
    assert abs(tres["mAP"] - jres["mAP"]) <= 1e-6
    assert tres["per_class"].keys() == jres["per_class"].keys()
    # data-parallel over a world of one: the evaluator sees the same rows
    mrows = []
    monkeypatch.setattr(tce, "DetectionEvaluator", Recorder(tce.DetectionEvaluator.base, mrows))
    mesh = parallel.make_mesh(device="cpu")
    try:
        mres, _ = tce.run_coco_eval(tcoco.CocoDataset(second, img_dir), params, tcfg,
                                    batch_size=3, mesh=mesh, verbose=False, device="cpu")
    finally:
        dist.destroy_process_group()
    assert abs(mres["mAP"] - jres["mAP"]) <= 1e-6
    assert len(mrows) == len(trows)
    for got, want in zip(mrows, trows):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
