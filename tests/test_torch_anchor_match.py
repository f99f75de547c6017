"""Anchor matching: the port's plain version against JAX's XLA version and
its Pallas kernel (interpret mode on the CPU).

The port's function is batched over images (shared anchors [A, 4], GT
[B, G, 4]); the JAX functions run per image. The CUDA kernel is held against
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, stated: per-anchor and per-GT maxima within rtol 1e-6 (XLA on
the CPU may contract an area product and a sum into one FMA, which moves an
IoU by an ulp); argmaxes equal. Ties (duplicated GT boxes, duplicated
anchors) go to the lowest index on every side; a GT that is invalid or
overlaps no anchor comes out as (0, 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu.anchors import config_anchors as j_config_anchors
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES
from objectdetection_tpu.ops.anchor_match import anchor_match_pallas, anchor_match_xla

from objectdetection_torch.ops import anchor_match as am

torch.set_num_threads(1)


def random_boxes(rng, n):
    c = rng.rand(n, 2) * 0.8 + 0.1
    s = rng.rand(n, 2) * 0.1 + 0.02
    return np.concatenate([c - s, c + s], axis=1).astype(np.float32)


def make_case(seed, a, g, b=2):
    rng = np.random.RandomState(seed)
    anchors = random_boxes(rng, a)
    anchors[a // 2] = anchors[3]  # a duplicated anchor: GT argmax ties go low
    gt = np.stack([random_boxes(rng, g) for _ in range(b)])
    gt[:, 1] = gt[:, 0]  # a duplicated GT: anchor argmax ties go low
    gt[:, 2] = [0.95, 0.95, 0.951, 0.951]  # overlaps (almost) nothing
    gt[:, 3] = anchors[3]  # its best anchors are 3 and a // 2, equal
    valid = rng.rand(b, g) > 0.25
    valid[:, :4] = True
    valid[-1] = False  # an image whose GTs are all invalid
    return anchors, gt, valid


def check(got, want, i):
    np.testing.assert_allclose(got.anchor_max[i].numpy(), np.asarray(want.anchor_max),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.gt_max[i].numpy(), np.asarray(want.gt_max), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.anchor_argmax[i].numpy(), np.asarray(want.anchor_argmax))
    np.testing.assert_array_equal(got.gt_argmax[i].numpy(), np.asarray(want.gt_argmax))


@pytest.mark.parametrize("seed,a,g", [(0, 500, 12), (1, 1024, 7), (2, 3000, 40)])
def test_plain_matches_xla(seed, a, g):
    anchors, gt, valid = make_case(seed, a, g)
    got = am.anchor_match(*(torch.from_numpy(x) for x in (anchors, gt, valid)))
    assert got.anchor_argmax.dtype == torch.int32 and got.gt_argmax.dtype == torch.int32
    for i in range(gt.shape[0]):
        check(got, anchor_match_xla(jnp.asarray(anchors), jnp.asarray(gt[i]),
                                    jnp.asarray(valid[i])), i)
    assert int(got.gt_argmax[0, 3]) == 3  # the tie between anchors 3 and a // 2
    assert int(got.anchor_argmax[0, 3]) == 3  # an anchor matching GT 3 exactly...
    assert float(got.anchor_max[0, 3]) == 1.0
    assert (got.gt_max[-1] == 0).all() and (got.gt_argmax[-1] == 0).all()
    assert (got.anchor_max[-1] == 0).all() and (got.anchor_argmax[-1] == 0).all()


@pytest.mark.parametrize("seed,a,g,tile", [(3, 500, 12, 128), (4, 1024, 7, 256)])
def test_plain_matches_pallas_interpret(seed, a, g, tile):
    anchors, gt, valid = make_case(seed, a, g)
    got = am.anchor_match(*(torch.from_numpy(x) for x in (anchors, gt, valid)))
    for i in range(gt.shape[0]):
        check(got, anchor_match_pallas(jnp.asarray(anchors), jnp.asarray(gt[i]),
                                       jnp.asarray(valid[i]), tile_size=tile,
                                       interpret=True), i)


def test_plain_matches_xla_on_config_anchors():
    anchors = j_config_anchors(J_SHAPES)  # 128², 5 levels
    rng = np.random.RandomState(5)
    y1x1 = rng.uniform(0, 0.7, (2, 9, 2))
    gt = np.concatenate([y1x1, y1x1 + rng.uniform(0.05, 0.3, (2, 9, 2))], -1).astype(np.float32)
    valid = rng.rand(2, 9) > 0.3
    got = am.anchor_match(*(torch.from_numpy(x) for x in (anchors, gt, valid)))
    for i in range(2):
        check(got, anchor_match_xla(jnp.asarray(anchors), jnp.asarray(gt[i]),
                                    jnp.asarray(valid[i])), i)


def test_all_invalid_gt():
    rng = np.random.RandomState(6)
    anchors = random_boxes(rng, 256)
    gt = random_boxes(rng, 4)[None]
    got = am.anchor_match(torch.from_numpy(anchors), torch.from_numpy(gt),
                          torch.zeros(1, 4, dtype=torch.bool))
    want = anchor_match_pallas(jnp.asarray(anchors), jnp.asarray(gt[0]), jnp.zeros(4, bool),
                               tile_size=128, interpret=True)
    check(got, want, 0)
    assert (got.anchor_max == 0).all() and (got.gt_argmax == 0).all()


def test_kernel_wrapper_rejects_what_it_cannot_take():
    anchors = torch.rand(8, 4)
    with pytest.raises(ValueError, match="device"):
        am.anchor_match(anchors.to("meta"), torch.rand(1, 2, 4).to("meta"),
                        torch.ones(1, 2, dtype=torch.bool).to("meta"))
