"""Stage parity of the port's networks against the flax modules, and the
weight bridge.

The weights are the flax tree's own layout filled with numpy-seeded values
(random BatchNorm statistics included, so that the eps and the folding are
exercised), converted with ``flax_to_state_dict``. Each stage is fed the JAX
stage's own inputs. Tolerance rtol/atol 1e-4 in f32: the frameworks sum the
convolutions in different orders (~1e-6 relative per layer), compounded over
the ~50 layers of ResNet-50 + FPN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu import detector as jdet
from objectdetection_tpu.config import COCO_CONFIG as J_COCO
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES

from objectdetection_torch.config import COCO_CONFIG as T_COCO
from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.convert import flax_to_state_dict
from objectdetection_torch.detector import build_model
from objectdetection_torch.models.mask_rcnn import MaskRCNN

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
F32 = dict(compute_dtype="float32")


def tree_shapes(cfg):
    model = jdet.build_model(cfg)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return jax.tree.map(lambda s: s.shape, tree)


def random_tree(shapes, seed):
    rng = np.random.RandomState(seed)

    def fill(path, shape):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, 1.0 / np.sqrt(fan_in), shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(
        fill, shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.fixture(scope="module")
def r50():
    jcfg = J_SHAPES.replace(**F32)
    variables = random_tree(tree_shapes(jcfg), seed=0)
    return variables, flax_to_state_dict(variables)


def torch_model(tcfg, params):
    model = MaskRCNN(tcfg)
    model.load_state_dict(params)
    return model.eval()


@pytest.mark.parametrize("size", [64, 128])
def test_backbone_and_rpn_match_jax(r50, size):
    variables, params = r50
    shape = dict(image_shape=(size, size, 3), image_min_dim=size, image_max_dim=size, **F32)
    jcfg, tcfg = J_SHAPES.replace(**shape), T_SHAPES.replace(**shape)
    images = np.random.RandomState(size).uniform(-100, 100, (2, size, size, 3)).astype(np.float32)
    jm = jdet.build_model(jcfg)
    jfeats, jlog, jprob, jdel = jax.jit(
        lambda v, x: jm.apply(v, x, method=jm.extract))(variables, jnp.asarray(images))
    with torch.inference_mode():
        tfeats, tlog, tprob, tdel = torch_model(tcfg, params).extract(torch.from_numpy(images))
    assert len(tfeats) == 5
    for jf, tf in zip(jfeats, tfeats):
        assert tuple(tf.shape) == jf.shape
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    for j, t in ((jlog, tlog), (jprob, tprob), (jdel, tdel)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_box_and_mask_heads_match_jax(r50):
    variables, params = r50
    shape = dict(image_shape=(128, 128, 3), image_min_dim=128, image_max_dim=128, **F32)
    jcfg, tcfg = J_SHAPES.replace(**shape), T_SHAPES.replace(**shape)
    rng = np.random.RandomState(7)
    feats = [rng.normal(0, 1, (2, s, s, 256)).astype(np.float32) for s in (32, 16, 8, 4, 2)]
    y1x1 = rng.uniform(0, 0.7, (2, 12, 2))
    rois = np.concatenate([y1x1, y1x1 + rng.uniform(0.05, 0.3, (2, 12, 2))], -1)
    rois = rois.astype(np.float32)
    cls = rng.randint(0, jcfg.num_classes, (2, 12)).astype(np.int32)
    jm = jdet.build_model(jcfg)
    jf = [jnp.asarray(f) for f in feats]
    jlog, jprob, jbox = jax.jit(lambda v, f, r: jm.apply(v, f, r, method=jm.classify_rois))(
        variables, jf, jnp.asarray(rois))
    jmask = jax.jit(lambda v, f, r, c: jm.apply(v, f, r, c, method=jm.predict_masks))(
        variables, jf, jnp.asarray(rois), jnp.asarray(cls))
    pooled = rng.normal(0, 1, (2, 3, 14, 14, 256)).astype(np.float32)
    jall = jax.jit(lambda v, p: jm.apply(v, p, method=lambda m, p: m.mask_head(p)))(
        variables, jnp.asarray(pooled))

    model = torch_model(tcfg, params)
    tf = [torch.from_numpy(f) for f in feats]
    with torch.inference_mode():
        tlog, tprob, tbox = model.classify_rois(tf, torch.from_numpy(rois))
        tmask = model.predict_masks(tf, torch.from_numpy(rois), torch.from_numpy(cls))
        tall = model.mrcnn_mask(torch.from_numpy(pooled), None, torch.float32)
    for j, t in ((jlog, tlog), (jprob, tprob), (jbox, tbox), (jmask, tmask), (jall, tall)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("name", ["shapes_r50", "coco_r101"])
def test_every_flax_leaf_maps_by_name_and_shape(name):
    jcfg, tcfg = {"shapes_r50": (J_SHAPES, T_SHAPES), "coco_r101": (J_COCO, T_COCO)}[name]
    shapes = tree_shapes(jcfg)
    zeros = jax.tree.map(lambda s: np.zeros(s, np.float32), shapes,
                         is_leaf=lambda x: isinstance(x, tuple))
    converted = flax_to_state_dict(zeros)
    expected = build_model(tcfg).state_dict()
    assert sorted(converted) == sorted(expected)
    for key, t in expected.items():
        assert tuple(converted[key].shape) == tuple(t.shape), key


def test_deconv_kernel_is_flipped():
    # flax ConvTranspose does not flip its kernel; torch's transposed conv
    # does, so the converter flips it in space (unflipped, the masks differ)
    k = np.arange(16, dtype=np.float32).reshape(2, 2, 2, 2)
    tree = {"params": {"mrcnn_mask": {"mrcnn_mask_deconv": {"kernel": k}}}}
    w = flax_to_state_dict(tree)["mrcnn_mask.mrcnn_mask_deconv.weight"].numpy()
    np.testing.assert_array_equal(w, k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
