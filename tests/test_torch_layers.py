"""Proposal and detection layers of the port against the JAX package.

Each layer gets the JAX layer's own inputs (numpy-seeded). Discrete results
are held exactly: the top-k selection order (ties included), which proposals
and detections exist, their class ids and scores. Box coordinates are held at
atol 1e-6: XLA on the CPU contracts the box decode's multiply-adds into FMAs
under jit and its ``exp`` differs from torch's in the last bit, so decoded
coordinates may differ by an ulp (~6e-8 on [0, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu.anchors import config_anchors as j_anchors
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES
from objectdetection_tpu.layers.detection import detection_layer as j_detection
from objectdetection_tpu.layers.proposals import proposal_layer as j_proposals

from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.layers.detection import detection_layer as t_detection
from objectdetection_torch.layers.proposals import proposal_layer as t_proposals
from objectdetection_torch.layers.proposals import top_k_stable

torch.set_num_threads(1)

SMALL = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
             pre_nms_rois_count=300, post_nms_rois_inference=64,
             use_approx_topk=False, compute_dtype="float32")


def test_top_k_ties_go_to_the_lower_index():
    rng = np.random.RandomState(0)
    scores = rng.randint(0, 5, (2, 400)).astype(np.float32) / 4  # heavy ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), 120)
    got_v, got_i = top_k_stable(torch.from_numpy(scores), 120)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def rpn_outputs(rng, a, tie_rows=0):
    logits = rng.normal(0, 2, (2, a, 2)).astype(np.float32)
    if tie_rows:  # identical foreground scores on a block of anchors
        logits[:, :tie_rows] = logits[:, :1]
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    deltas = rng.normal(0, 1, (2, a, 4)).astype(np.float32)
    return probs, deltas


@pytest.mark.parametrize("tie_rows", [0, 200])
def test_proposal_layer_matches_jax(tie_rows):
    jcfg, tcfg = J_SHAPES.replace(**SMALL), T_SHAPES.replace(**SMALL)
    anchors = j_anchors(jcfg)
    probs, deltas = rpn_outputs(np.random.RandomState(1), anchors.shape[0], tie_rows)
    want = np.asarray(jax.jit(lambda p, d: j_proposals(p, d, jnp.asarray(anchors), jcfg))(
        jnp.asarray(probs), jnp.asarray(deltas)))
    got = t_proposals(torch.from_numpy(probs), torch.from_numpy(deltas),
                      torch.from_numpy(anchors), tcfg).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal((got != 0).any(-1), (want != 0).any(-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("threshold", [0.7, 0.0])
def test_detection_layer_matches_jax(threshold):
    cfg_kw = dict(SMALL, detection_min_threshold=threshold, detection_post_nms_instances=40)
    jcfg, tcfg = J_SHAPES.replace(**cfg_kw), T_SHAPES.replace(**cfg_kw)
    rng = np.random.RandomState(2)
    p, k = 64, jcfg.num_classes
    y1x1 = rng.uniform(0, 0.7, (2, p, 2))
    props = np.concatenate([y1x1, y1x1 + rng.uniform(0.05, 0.3, (2, p, 2))], -1)
    props = props.astype(np.float32)
    props[:, -6:] = 0.0  # zero-padded proposal rows
    logits = rng.normal(0, 3, (2, p, k)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    deltas = rng.normal(0, 1, (2, p, k, 4)).astype(np.float32)
    window = np.array([[0.05, 0.0, 0.9, 1.0], [0.0, 0.1, 1.0, 0.8]], np.float32)
    want = np.asarray(jax.jit(lambda *a: j_detection(*a, jcfg))(
        *(jnp.asarray(x) for x in (props, probs, deltas, window))))
    got = t_detection(*(torch.from_numpy(x) for x in (props, probs, deltas, window)),
                      tcfg).numpy()
    assert got.shape == want.shape == (2, 40, 6)
    assert (want[..., 5] > 0).sum() > 0
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])  # class ids, scores
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-6)
