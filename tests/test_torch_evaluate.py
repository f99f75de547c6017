"""The port's evaluator (``objectdetection_torch.evaluate``) against JAX's.

Every case of ``tests/test_evaluate.py`` (box AP, crowd regions, mask AP)
goes through both evaluators, one parametrised test, and their results
(mAP, AP50, per-class AP) must be identical; so must random detections
over several images, classes and IoU sweeps, with crowd regions and masks.
Both are numpy; the port's is a copy, so identity is the tolerance.
"""

import numpy as np
import pytest
import torch

from objectdetection_tpu import evaluate as jev

from objectdetection_torch import evaluate as tev

torch.set_num_threads(1)

GT1 = np.array([[0, 0, 10, 10]], np.float32)
GT2 = np.array([[0, 0, 10, 10], [20, 20, 30, 30]], np.float32)
PREDS = np.array([[0, 0, 10, 10], [50, 50, 60, 60]], np.float32)
CROWD = np.array([[45, 45, 70, 70]], np.float32)


def _mask(y1, x1, y2, x2, h=16, w=16):
    m = np.zeros((h, w), bool)
    m[y1:y2, x1:x2] = True
    return m[None]


FULL = np.array([[0, 0, 16, 16]], np.float32)
MASK_BOX = np.array([[2, 2, 10, 10]], np.float32)

# (evaluator kwargs, add_image calls (args, kwargs), expected mAP)
CASES = {
    "perfect": (dict(num_classes=3), [((GT2, [1, 2], [0.9, 0.8], GT2, [1, 2]), {})], 1.0),
    "miss_halves_recall": (dict(num_classes=2),
                           [((GT2[:1], [1], [0.9], GT2, [1, 1]), {})], 0.5),
    "false_positive": (dict(num_classes=2), [((PREDS, [1, 1], [0.5, 0.9], GT1, [1]), {})], 0.5),
    "localization": (dict(num_classes=2, iou_thresholds=[0.5, 0.9]),
                     [((np.array([[0, 0, 10, 8.0]]), [1], [0.9], GT1, [1]), {})], 0.5),
    "wrong_class": (dict(num_classes=3), [((GT1, [2], [0.9], GT1, [1]), {})], 0.0),
    "duplicate": (dict(num_classes=2), [((np.tile(GT1, (2, 1)), [1, 1], [0.9, 0.8], GT1, [1]),
                                         {})], 1.0),
    "crowd_ignored": (dict(num_classes=2), [((PREDS, [1, 1], [0.5, 0.9], GT1, [1]),
                                             dict(ignore_boxes=CROWD, ignore_classes=[1]))], 1.0),
    "crowd_other_class": (dict(num_classes=3), [((PREDS, [1, 1], [0.5, 0.9], GT1, [1]),
                                                 dict(ignore_boxes=CROWD, ignore_classes=[2]))],
                          0.5),
    "perfect_masks": (dict(num_classes=2, use_masks=True), [((MASK_BOX, [1], [0.9], MASK_BOX, [1]),
                      dict(pred_masks=_mask(2, 2, 10, 10), gt_masks=_mask(2, 2, 10, 10)))], 1.0),
    "masks_disjoint": (dict(num_classes=2, use_masks=True), [((FULL, [1], [0.9], FULL, [1]),
                       dict(pred_masks=_mask(0, 0, 16, 8), gt_masks=_mask(0, 8, 16, 16)))], 0.0),
    "mask_partial_overlap": (dict(num_classes=2, use_masks=True, iou_thresholds=[0.5, 0.9]),
                             [((FULL, [1], [0.9], FULL, [1]),
                               dict(pred_masks=_mask(0, 0, 16, 12),
                                    gt_masks=_mask(0, 0, 16, 16)))], 0.5),
}


def run(module, kwargs, calls):
    ev = module.DetectionEvaluator(**kwargs)
    for args, kw in calls:
        ev.add_image(*args, **kw)
    return ev.evaluate()


@pytest.mark.parametrize("name", sorted(CASES))
def test_cases_of_the_jax_evaluator_tests(name):
    kwargs, calls, want_map = CASES[name]
    got, want = run(tev, kwargs, calls), run(jev, kwargs, calls)
    assert got == want
    assert abs(got["mAP"] - want_map) < 1e-6


def test_average_precision_equals_jax():
    for r, p in (([1.0], [1.0]), ([0.5, 1.0], [0.5, 0.5]), ([0.2, 0.2, 0.6], [1.0, 0.5, 0.6])):
        assert tev.average_precision(np.array(r), np.array(p)) == \
            jev.average_precision(np.array(r), np.array(p))
    assert tev.coco_iou_thresholds() == jev.coco_iou_thresholds()


def _random_images(rng, n_images, num_classes, h=32, w=32):
    out = []
    for _ in range(n_images):
        g = rng.randint(0, 6)
        y1x1 = rng.uniform(0, 20, (g, 2))
        gt = np.concatenate([y1x1, y1x1 + rng.uniform(3, 12, (g, 2))], 1).astype(np.float32)
        gc = rng.randint(1, num_classes, g)
        keep = rng.rand(g) < 0.8
        jit = rng.randn(int(keep.sum()), 4) * rng.choice([0.0, 0.5, 2.0])
        extra = rng.randint(0, 4)
        y1x1 = rng.uniform(0, 20, (extra, 2))
        spur = np.concatenate([y1x1, y1x1 + rng.uniform(2, 10, (extra, 2))], 1)
        pb = np.concatenate([gt[keep] + jit, spur]).astype(np.float32)
        pc = np.concatenate([np.where(rng.rand(int(keep.sum())) < 0.85, gc[keep],
                                      rng.randint(1, num_classes, int(keep.sum()))),
                             rng.randint(1, num_classes, extra)])
        ps = rng.rand(len(pb)).astype(np.float32)
        crowd = rng.uniform(0, 24, (rng.randint(0, 2), 4)).astype(np.float32)
        crowd[:, 2:] = crowd[:, :2] + 8
        masks_of = lambda boxes: np.stack(
            [_mask(*np.clip(np.round(b), 0, h).astype(int), h=h, w=w)[0] for b in boxes]
        ) if len(boxes) else np.zeros((0, h, w), bool)
        out.append(((pb, pc, ps, gt, gc), dict(
            ignore_boxes=crowd, ignore_classes=rng.randint(1, num_classes, len(crowd)),
            pred_masks=masks_of(pb), gt_masks=masks_of(gt))))
    return out


@pytest.mark.parametrize("use_masks", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_detections_equal_jax(seed, use_masks):
    rng = np.random.RandomState(seed)
    calls = _random_images(rng, 6, 5)
    for thresholds in ([0.5], tev.coco_iou_thresholds()):
        kwargs = dict(num_classes=5, iou_thresholds=thresholds, use_masks=use_masks)
        got, want = run(tev, kwargs, calls), run(jev, kwargs, calls)
        assert got == want
        assert got["per_class"]
