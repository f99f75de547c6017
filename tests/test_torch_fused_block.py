"""The fused int8 identity block (B4) against the JAX package and the port's
unfused int8 block, on the CPU.

``fused_identity_block_int8_plain`` (the kernel's plain version, which the
wrapper runs for CPU tensors) gets the inputs of ``tests/test_fused_block.py``'s
``make_case`` (same seeds and shapes, every BatchNorm affine nonzero):

- against ``objectdetection_tpu.ops.fused_block.fused_identity_block_int8``
  run in Pallas interpret mode: within 1 int8 step, the share of differing
  codes below 5e-3 (the f32 scale folds agree; JAX's interpreted kernel may
  contract a multiply-add where the port rounds twice, which moves a value
  on a rounding boundary by one step);
- against the port's own unfused int8 block (three QuantConv + FrozenBatchNorm
  with every BatchNorm statistic drawn from the seed, f32 compute): within 2
  steps (the unfused path rounds its affines in other places);
- the gate copies JAX's, case by case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu.ops import fused_block as jfb

from objectdetection_torch.models.backbone import BottleneckBlock, Quant
from objectdetection_torch.ops import fused_block as tfb

torch.set_num_threads(1)
TH = jfb.TH


def make_case(rng, b, h, w, c3, c1):
    """tests/test_fused_block.py make_case, as numpy arrays."""
    x8 = rng.randint(-128, 128, (b, h, w, c3)).astype(np.int8)
    k = lambda *s: rng.randint(-127, 128, s).astype(np.int8)
    v = lambda n, lo=0.5, hi=1.5: rng.uniform(lo, hi, (n,)).astype(np.float32)
    return dict(
        x8=x8, sx=np.float32(3.0),
        ka8=k(1, 1, c3, c1), kb8=k(3, 3, c1, c1), kc8=k(1, 1, c1, c3),
        sw=(v(c1) * 0.01, v(c1) * 0.002, v(c3) * 0.01),
        biases=(v(c1, -0.2, 0.2), v(c1, -0.2, 0.2), v(c3, -0.2, 0.2)),
        bns=((v(c1), v(c1, -0.3, 0.3)), (v(c1), v(c1, -0.3, 0.3)), (v(c3), v(c3, -0.3, 0.3))),
        s_b=np.float32(4.0), s_c=np.float32(5.0), s_out=np.float32(6.0),
    )


def args(case, conv):
    return (conv(case["x8"]), conv(case["sx"]), conv(case["ka8"]), conv(case["kb8"]),
            conv(case["kc8"]), *[conv(s) for s in case["sw"]],
            *[conv(s) for s in case["biases"]],
            *[tuple(conv(a) for a in bn) for bn in case["bns"]],
            conv(case["s_b"]), conv(case["s_c"]), conv(case["s_out"]))


def steps(a, b):
    return np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))


@pytest.mark.parametrize("b,h,w,c3,c1", [
    (1, 2 * TH, 8, 64, 64),  # stage-2-like narrow channels
    (1, 2 * TH, 4, 128, 64),  # wider stream
    (1, 3 * TH, 16, 64, 64),  # interior tiles
    (2, 2 * TH, 8, 64, 64),  # batch
])
def test_plain_matches_jax_interpret(b, h, w, c3, c1):
    case = make_case(np.random.RandomState(0 if b == 1 else 1), b, h, w, c3, c1)
    want = jfb.fused_identity_block_int8(*args(case, jnp.asarray), interpret=True)
    got = tfb.fused_identity_block_int8(*args(case, lambda a: torch.from_numpy(np.array(a))))
    assert got.dtype == torch.int8 and tuple(got.shape) == (b, h, w, c3)
    diff = steps(got.numpy(), want)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 5e-3, (diff > 0).mean()


def _unfused_block(case, c3, c1):
    """The port's unfused int8 identity block holding the case's frozen
    weights and scales, with random BatchNorm statistics whose folded affine
    is handed to the fused version."""
    rng = np.random.RandomState(7)
    blk = BottleneckBlock(c3, (c1, c1, c3), 1, False, 2, "b",
                          Quant(dtype=torch.float32)).eval()
    sd = {}
    t = lambda a: torch.from_numpy(np.array(a))
    for s, k, sw, bias in zip("abc", ("ka8", "kb8", "kc8"), case["sw"], case["biases"]):
        sd[f"res2b_branch2{s}.weight"] = t(case[k]).permute(3, 2, 0, 1).contiguous()
        sd[f"res2b_branch2{s}.kernel_scale"] = t(sw)
        sd[f"res2b_branch2{s}.bias"] = t(bias)
        n = sw.shape[0]
        sd[f"bn2b_branch2{s}.scale"] = t(rng.uniform(0.5, 1.5, n).astype(np.float32))
        sd[f"bn2b_branch2{s}.bias"] = t(rng.uniform(-0.3, 0.3, n).astype(np.float32))
        sd[f"bn2b_branch2{s}.mean"] = t(rng.normal(0, 0.3, n).astype(np.float32))
        sd[f"bn2b_branch2{s}.var"] = t(rng.uniform(0.5, 2.0, n).astype(np.float32))
    sd["res2b_branch2a.act_scale"] = t(case["sx"])
    sd["res2b_branch2b.act_scale"] = t(case["s_b"])
    sd["res2b_branch2c.act_scale"] = t(case["s_c"])
    sd["out_scale"] = t(case["s_out"])
    blk.load_state_dict(sd, assign=True)
    bns = tuple(tuple(a.numpy() for a in blk._modules[f"bn2b_branch2{s}"].folded())
                for s in "abc")
    return blk, dict(case, bns=bns)


@pytest.mark.parametrize("h,w,c3,c1", [(2 * TH, 8, 64, 64), (2 * TH, 4, 128, 64)])
def test_plain_matches_the_unfused_int8_block(h, w, c3, c1):
    case = make_case(np.random.RandomState(2), 2, h, w, c3, c1)
    blk, case = _unfused_block(case, c3, c1)
    with torch.inference_mode():
        y8, scale = blk((torch.from_numpy(case["x8"]), torch.tensor(case["sx"])))
        fused = tfb.fused_identity_block_int8(*args(case, lambda a: torch.from_numpy(np.array(a))))
    assert float(scale) == float(case["s_out"])
    diff = steps(fused.numpy(), y8.numpy())
    assert diff.max() <= 2, diff.max()
    assert (diff > 1).mean() < 1e-3


def test_the_block_fuses_where_jax_fuses():
    c1, c3 = 64, 64
    case = make_case(np.random.RandomState(3), 1, 2 * TH, 8, c3, c1)
    blk, case = _unfused_block(case, c3, c1)
    x = (torch.from_numpy(case["x8"]), torch.tensor(case["sx"]))
    fused_blk = BottleneckBlock(c3, (c1, c1, c3), 1, False, 2, "b",
                                Quant(dtype=torch.float32, fused=True)).eval()
    fused_blk.load_state_dict(blk.state_dict(), assign=True)
    with torch.inference_mode():
        got, _ = fused_blk(x)
        want = tfb.fused_identity_block_int8(*args(case, lambda a: torch.from_numpy(np.array(a))))
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,c1", [
    ((1, 2 * TH, 8, 64), 64),
    ((1, 8, 8, 64), 64),  # a single tile at the smallest tiling
    ((1, 2 * TH + 1, 8, 64), 64),  # no tiling divides the height
    ((1, 16, 8, 64), 64),
    ((2, 256, 256, 256), 64),  # stage 2 at 1024²
    ((2, 32, 32, 2048), 512),  # stage 5 at 1024²
    ((1, 2 * TH, 8, 64), 32),  # bottleneck width not a multiple of 64
    ((1, 2 * TH, 2, 64), 64),  # narrower than the 3×3
    ((1, 2 * TH, 3, 40), 64),  # W·C3 not a multiple of 128
])
def test_gate_matches_jax(shape, c1):
    want = jfb.fused_block_supported(jnp.zeros(shape, jnp.int8), c1)
    assert tfb.fused_block_supported(torch.zeros(shape, dtype=torch.int8), c1) == want
    assert not tfb.fused_block_supported(torch.zeros(shape, dtype=torch.bfloat16), c1)
    assert tfb.pick_tile(shape[1]) == jfb.pick_tile(shape[1])


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    case = make_case(np.random.RandomState(4), 1, 8, 8, 64, 64)  # one tile only
    a = args(case, lambda v: torch.from_numpy(np.array(v)))
    with pytest.raises(ValueError, match="unsupported device"):
        tfb.fused_identity_block_int8(a[0].to("meta"), *a[1:])
