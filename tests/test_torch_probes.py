"""The ROIAlign design probes (P1-P3): the port's plain versions against the
TPU scripts' Pallas kernels, run on the CPU by JAX's interpreter.

The scripts under ``benchmarks/`` are loaded by path; their kernels run as
the scripts call them, at a small size (P1: 8 patches of 8² from a
[2, 32, 32, 256] source; P2 and P3: 16 ROIs, one grid step, the scripts'
own grid specs, with ``uninitialized_memory="zero"``, which gives P2's
``noblend`` scratch and P3's uncopied columns the zeros the port reads).

Tolerances:

- P1: within n·2^-24·Σ|x| per channel (``patch_dma.tolerance``): the kernel
  adds in ROI order in f32, the plain version in f64.
- P2 and P3: bit-equal, except where XLA's CPU jit contracts the blend
  ``(1 - w)·v0 + w·v1`` into a fused multiply-add and the bf16 rounding of
  xb flips; such outputs are held within one bf16 ulp of the larger of the
  two values, and their share is printed (measured: 0 on these inputs;
  0.002% for ``dispatch_small`` at 16 ROIs).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from objectdetection_torch.probes import common, patch_dma, roi_dispatch, roi_inner

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 16  # one grid step of P2 and P3


def load(name):
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_torch(x):
    """A JAX array as a torch tensor of the same dtype and bits."""
    a = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def assert_bf16_close(got, want):
    """Bit-equal, or within one bf16 ulp where XLA contracted the blend."""
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    diff = g != w
    share = float(diff.mean())
    print(f"outputs differing from the interpreted kernel: {share:.3%}")
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(g), np.abs(w)) + 1e-30)) - 7)
    assert np.all(np.abs(g - w)[diff] <= ulp[diff])
    assert np.isfinite(g).all()


def test_patch_dma_plain_matches_interpreted_kernel():
    mod = load("patch_dma_probe")
    rng = np.random.RandomState(0)
    n, p, shape = 8, 8, (2, 32, 32, 256)
    src = jnp.asarray(rng.normal(0, 1, shape), jnp.bfloat16)
    i = jnp.asarray(rng.randint(0, shape[0], n), jnp.int32)
    y = jnp.asarray(rng.randint(0, shape[1] - p, n), jnp.int32)
    xq = jnp.asarray(rng.randint(0, (shape[2] - p) // 8, n), jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mod.make_probe(n, p, shape[3], shape)(i, y, xq, src))
    args = (to_torch(src), to_torch(i), to_torch(y), to_torch(xq))
    got = patch_dma.patch_dma(*args, p)
    assert got.shape == (1, 256) and got.dtype == torch.float32
    tol = patch_dma.tolerance(*args).numpy()
    assert np.all(np.abs(got.numpy() - want) <= tol)
    np.testing.assert_array_equal(patch_dma.library_call(*args, p).numpy(), got.numpy())


def inner_call(mod, variant, n):
    K, POOL, PY, PX, C = mod.K, mod.POOL, mod.PY, mod.PX, mod.C
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=0,
        grid=(n // K,),
        in_specs=[
            pl.BlockSpec((K, 1, 2 * POOL), lambda g: (g, 0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((K, 1, POOL), lambda g: (g, 0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((K, POOL, 4), lambda g: (g, 0, 0)),
            pl.BlockSpec((PY, PX * C), lambda g: (0, 0)),
        ],
        out_specs=pl.BlockSpec((K, POOL, POOL * C), lambda g: (g, 0, 0)),
        scratch_shapes=[pltpu.VMEM((PY, POOL * C), jnp.bfloat16)],
    )
    return pl.pallas_call(
        lambda *refs: mod.kernel(*refs, variant=variant),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((n, POOL, POOL * C), jnp.bfloat16),
        interpret=pltpu.InterpretParams(uninitialized_memory="zero"),
    )


@pytest.fixture(scope="module")
def inner_inputs():
    # the script's recipe (roi_inner_probe.py:117-142) at n = 16
    xint, wx, geom, patch = roi_inner.make_inputs(N, "cpu")
    rng = np.random.RandomState(0)
    for _ in range(3):
        rng.randint(0, 1, (N, 1, roi_inner.POOL))  # the draws before the patch
    rng.rand(N, 1, roi_inner.POOL)
    rng.randint(0, 1, (N, roi_inner.POOL)), rng.randint(0, 1, (N, roi_inner.POOL))
    rng.rand(N, roi_inner.POOL), rng.rand(N, roi_inner.POOL)
    jpatch = jnp.asarray(rng.rand(roi_inner.PY, roi_inner.PX * roi_inner.C), jnp.bfloat16)
    return (xint, wx, geom, to_torch(jpatch)), jpatch


@pytest.mark.parametrize("variant", roi_inner.VARIANTS)
def test_roi_inner_plain_matches_interpreted_kernel(variant, inner_inputs):
    (xint, wx, geom, patch), jpatch = inner_inputs
    mod = load("roi_inner_probe")
    want = inner_call(mod, variant, N)(jnp.asarray(xint.numpy()), jnp.asarray(wx.numpy()),
                                       jnp.asarray(geom.numpy()), jpatch)
    got = roi_inner.roi_inner(xint, wx, geom, patch, variant)
    assert got.shape == (N, 7, 7 * 256) and got.dtype == torch.bfloat16
    assert_bf16_close(got, want)
    if variant == "noblend":
        assert not got.float().any()
    if variant == "pair2":
        assert torch.equal(got[0::2], got[1::2])
        full = roi_inner.roi_inner(xint, wx, geom, patch, "full")
        assert torch.equal(got[1::2], full[1::2])


def dispatch_call(mod, variant, n):
    K, POOL, C = mod.K, mod.POOL, mod.C
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=0,
        grid=(n // K,),
        in_specs=[
            pl.BlockSpec((K, 1, 8), lambda g: (g, 0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((K, 1, 8), lambda g: (g, 0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((K, 1, POOL), lambda g: (g, 0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((K, 1, POOL), lambda g: (g, 0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((K, POOL, 4), lambda g: (g, 0, 0)),
            pl.BlockSpec((32, 32 * C), lambda g: (0, 0)),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((K, POOL, POOL * C), lambda g: (g, 0, 0)),
        scratch_shapes=[
            pltpu.VMEM((2, K, 24, 32 * C), jnp.int8),
            pltpu.SMEM((1,), jnp.int32),
            pltpu.VMEM((32, POOL * C), jnp.bfloat16),
            pltpu.SemaphoreType.DMA((2, K)),
        ],
    )
    return pl.pallas_call(
        lambda *refs: mod.kernel(*refs, variant=variant),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((n, POOL, POOL * C), jnp.bfloat16),
        interpret=pltpu.InterpretParams(uninitialized_memory="zero"),
    )


def dispatch_case(variant):
    """The script's inputs (roi_dispatch_probe.py:189-224) at n = 16, as
    JAX arrays (patch_top converted from f64 as the script converts it)."""
    meta, xint, wx, geom, _, feats = roi_dispatch.make_inputs(variant, N, "cpu")
    rng = np.random.RandomState(0)
    rng.randint(0, 1, N), rng.randint(0, 1, N), rng.randint(0, 1, (N, 1, 7))
    rng.rand(N, 1, 7), rng.randint(0, 1, (N, 7)), rng.randint(0, 1, (N, 7))
    rng.rand(N, 7), rng.rand(N, 7)
    jtop = jnp.asarray(rng.rand(32, 32 * 256), jnp.bfloat16)
    meta_np = meta.numpy()
    j = (jnp.asarray(meta_np), jnp.asarray(np.roll(meta_np, -roi_dispatch.K, axis=0)),
         jnp.asarray(xint.numpy()), jnp.asarray(wx.numpy()), jnp.asarray(geom.numpy()), jtop,
         jnp.asarray(feats.numpy()))
    return (meta, xint, wx, geom, to_torch(jtop), feats), j


@pytest.mark.parametrize("variant", [
    "bare", "dispatch_small", pytest.param("dispatch", marks=pytest.mark.slow)])
def test_roi_dispatch_plain_matches_interpreted_kernel(variant):
    args, jargs = dispatch_case(variant)
    mod = load("roi_dispatch_probe")
    n = N
    if variant == "dispatch_small":
        # the interpreter's DMAs take ~2 s per ROI: one grid step of 4 ROIs
        # (the loaded module's K, which sets ROIs per step, set to 4)
        n = mod.K = 4
        args = tuple(a[:n] if a.shape[0] == N else a for a in args)
        jargs = tuple(a[:n] if a.shape[0] == N else a for a in jargs)
    want = dispatch_call(mod, variant, n)(*jargs)
    got = roi_dispatch.roi_dispatch(*args, variant)
    assert got.shape == (n, 7, 7 * 256) and got.dtype == torch.bfloat16
    assert_bf16_close(got, want)
    if variant == "dispatch":
        assert torch.equal(got, roi_dispatch.roi_dispatch(*args, "bare"))


def test_roi_dispatch_raises_outside_the_combos():
    args, _ = dispatch_case("dispatch_small")
    meta = args[0].clone()
    meta[3, 0, 1], meta[3, 0, 2] = 3, 1  # class (16, 16) at the top level: no DMA on the TPU
    with pytest.raises(ValueError, match="combos"):
        roi_dispatch.roi_dispatch(meta, *args[1:], "dispatch")
    assert sorted(roi_dispatch.combos())[:3] == [(0, 0, 8, 8), (0, 1, 16, 16), (0, 2, 24, 24)]
    assert len(list(roi_dispatch.combos())) == 10


@pytest.mark.parametrize("call", [
    lambda: patch_dma.make_source((1, 8, 8, 8)),
    lambda: roi_inner.make_inputs(16),
    lambda: roi_dispatch.run("bare", 16, 1),
    lambda: patch_dma.main(["--n", "8", "--images", "1"]),
    lambda: roi_inner.main(["--n", "16"]),
    lambda: roi_dispatch.main(["--n", "16"]),
])
def test_probe_entry_points_need_the_card(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_probe_entry_points_run_the_plain_versions_on_the_cpu(capsys):
    before = (patch_dma.launches, roi_inner.launches, roi_dispatch.launches)
    patch_dma.main(["--device", "cpu", "--n", "8", "--images", "1", "--iters", "1"])
    roi_inner.main(["--device", "cpu", "--n", "16", "--iters", "1", "--variant", "wide2c"])
    roi_dispatch.main(["--device", "cpu", "--n", "16", "--iters", "1", "--variant", "bare"])
    assert (patch_dma.launches, roi_inner.launches, roi_dispatch.launches) == before
    out = capsys.readouterr().out
    assert "M dma/s" in out and "GB/s" in out
    assert "wide2c" in out and "ms for 16 ROIs" in out and "us/ROI" in out
    assert common.resolve_device("cpu").type == "cpu"
