"""The port's NMS (plain path, as the CPU runs it) against the JAX package.

Keep sets are held exactly: indices and validity equal to
``non_max_suppression(backend="xla")``, and survivor tables equal to the Pallas
kernel ``nms_suppress_pallas`` run in interpret mode, as
tests/test_nms_pallas.py runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu.ops import nms as jnms
from objectdetection_tpu.ops.nms_pallas import nms_suppress_pallas

from objectdetection_torch.ops import cuda_build
from objectdetection_torch.ops import nms as tnms

torch.set_num_threads(1)


def clustered(rng, b, n, clusters=6, num_classes=1, spread=0.02):
    centers = rng.uniform(0.2, 0.8, (b, clusters, 2))
    idx = rng.randint(0, clusters, (b, n))
    ctr = np.take_along_axis(centers, idx[..., None].repeat(2, -1), 1)
    ctr = ctr + rng.normal(0, spread, (b, n, 2))
    hw = rng.uniform(0.05, 0.2, (b, n, 2))
    boxes = np.concatenate([ctr - hw / 2, ctr + hw / 2], -1).astype(np.float32)
    scores = rng.uniform(0.01, 1, (b, n)).astype(np.float32)
    cls = rng.randint(0, num_classes, (b, n)).astype(np.int32)
    return boxes, scores, cls


def jax_nms(boxes, scores, max_output, thr, valid=None, cls=None, assume_sorted=False):
    idx, ok = [], []
    for i in range(boxes.shape[0]):
        res = jnms.non_max_suppression(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), max_output, thr,
            valid=None if valid is None else jnp.asarray(valid[i]),
            class_ids=None if cls is None else jnp.asarray(cls[i]),
            backend="xla", assume_sorted=assume_sorted,
        )
        idx.append(np.asarray(res.indices))
        ok.append(np.asarray(res.valid))
    return np.stack(idx), np.stack(ok)


def torch_nms(boxes, scores, max_output, thr, valid=None, cls=None, assume_sorted=False):
    res = tnms.non_max_suppression(
        torch.from_numpy(boxes), torch.from_numpy(scores), max_output, thr,
        valid=None if valid is None else torch.from_numpy(valid),
        class_ids=None if cls is None else torch.from_numpy(cls),
        assume_sorted=assume_sorted,
    )
    return res.indices.numpy(), res.valid.numpy()


@pytest.mark.parametrize("seed,n,max_output,thr", [
    (0, 300, 300, 0.5),   # every survivor, one partial tile
    (1, 600, 40, 0.7),    # budget stops inside the first tile
    (2, 700, 1000, 0.3),  # more slots than boxes: -1 padding
])
def test_keep_set_matches_xla(seed, n, max_output, thr):
    rng = np.random.RandomState(seed)
    boxes, scores, _ = clustered(rng, 2, n)
    ji, jv = jax_nms(boxes, scores, max_output, thr)
    ti, tv = torch_nms(boxes, scores, max_output, thr)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("seed", [3, 4])
def test_class_aware_with_invalid_rows_matches_xla(seed):
    rng = np.random.RandomState(seed)
    boxes, scores, cls = clustered(rng, 2, 400, clusters=3, num_classes=5)
    valid = rng.uniform(size=(2, 400)) > 0.2
    # inverted corners: both sides canonicalize before the IoU
    flip = rng.uniform(size=(2, 400)) < 0.1
    boxes[flip] = boxes[flip][:, [2, 3, 0, 1]]
    ji, jv = jax_nms(boxes, scores, 100, 0.3, valid=valid, cls=cls)
    ti, tv = torch_nms(boxes, scores, 100, 0.3, valid=valid, cls=cls)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)


def test_nms_boxes_matches_xla():
    rng = np.random.RandomState(5)
    boxes, scores, _ = clustered(rng, 2, 256)
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None].repeat(4, -1), 1)
    scores = np.take_along_axis(scores, order, 1)
    want = np.stack([
        np.asarray(jnms.nms_boxes(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 64, 0.6,
                                  backend="xla", assume_sorted=True))
        for i in range(2)
    ])
    got = tnms.nms_boxes(torch.from_numpy(boxes), torch.from_numpy(scores), 64, 0.6,
                         assume_sorted=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("budget,num_classes", [(None, 1), (20, 1), (30, 4)])
def test_survivor_table_matches_pallas_kernel(budget, num_classes):
    # 512 rows = two 256-row tiles, the kernel's tile; a budget stops the
    # pass after the tile that reaches it, in both implementations
    rng = np.random.RandomState(6)
    boxes, scores, cls = clustered(rng, 1, 512, num_classes=num_classes)
    order = np.argsort(-scores[0], kind="stable")
    sboxes, scls = boxes[0][order], cls[0][order]
    sboxes[-12:] = 0.0  # zero-padded tail, class -1
    scls[-12:] = -1
    want = np.asarray(nms_suppress_pallas(
        jnp.asarray(sboxes), jnp.asarray(scls), 0.5, tile_size=256, budget=budget,
        interpret=True,
    ))
    got = tnms.suppress(torch.from_numpy(sboxes)[None], torch.from_numpy(scls)[None],
                        0.5, budget=budget)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensor_takes_plain_version_without_counting():
    rng = np.random.RandomState(7)
    boxes, _, cls = clustered(rng, 2, 300)
    before = cuda_build.launches("nms")
    out = tnms.suppress(torch.from_numpy(boxes), torch.from_numpy(cls), 0.5, budget=50)
    plain = tnms.suppress_plain(torch.from_numpy(boxes), torch.from_numpy(cls), 0.5, budget=50)
    assert cuda_build.launches("nms") == before
    assert torch.equal(out, plain)
