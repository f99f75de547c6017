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

from objectdetection_torch.ops import roi_align
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


# ------------------------------------ P2's split-tap product, as the card runs it
#
# csrc/roi_probes.cu runs P2's y-product on bf16 tensor cores split by tap:
# wy0 holds wy's entry at y0 of each row (where y0 == y1 the single entry),
# wy1 the entry at y1 where y1 != y0, so D0 = wy0 @ xb and D1 = wy1 @ xb are
# each one exact bf16 x bf16 product plus exact zeros, and out =
# bf16(D0 + D1) is one f32 addition. The model below does exactly that and
# is held bit-equal to the plain version (wy @ xb in f32).


def split_taps(geom, py=roi_inner.PY):
    """wy0, wy1 [k, 7, py] bf16 with wy0 + wy1 == wy and at most one nonzero
    entry per row each."""
    wy = roi_inner.wy_rows(geom, py)
    y0 = roi_align.xla_to_int32(geom[..., 0])[..., None]
    y1 = roi_align.xla_to_int32(geom[..., 1])[..., None]
    iota = torch.arange(py)
    zero = torch.zeros((), dtype=torch.bfloat16)
    return (torch.where(iota == y0, wy, zero),
            torch.where((iota == y1) & (y1 != y0), wy, zero))


def split_tap_model(xint, wx, geom, patch, variant):
    n = xint.shape[0]
    src = patch.float().reshape(1, roi_inner.PY, roi_inner.PX, roi_inner.C).expand(
        n, -1, -1, -1)
    q = torch.arange(roi_inner.POOL)
    x0, x1 = xint[:, 0, :7].long(), xint[:, 0, 7:].long()
    if variant == "static_x":
        x0, x1 = (4 * q).expand(n, 7), (4 * q + 1).expand(n, 7)
    elif variant == "wide2c":
        x1 = x0 + 1
    take = lambda x: torch.gather(src, 2, x[:, None, :, None].expand(n, roi_inner.PY, 7,
                                                                      roi_inner.C))
    w = wx[:, 0, None, :, None]
    xb = ((1.0 - w) * take(x0) + w * take(x1)).to(torch.bfloat16)  # [n, 32, 7, C]
    if variant == "nomatmul":
        return xb[:, :7].reshape(n, 7, 7 * roi_inner.C)
    if variant == "noblend":
        xb = torch.zeros_like(xb)
    wy0, wy1 = split_taps(geom)
    assert torch.equal(wy0.float() + wy1.float(), roi_inner.wy_rows(geom, roi_inner.PY).float())
    assert int((wy0 != 0).sum(-1).max()) <= 1 and int((wy1 != 0).sum(-1).max()) <= 1
    xb = xb.reshape(n, roi_inner.PY, 7 * roi_inner.C).float()
    d0, d1 = torch.bmm(wy0.float(), xb), torch.bmm(wy1.float(), xb)
    out = (d0 + d1).to(torch.bfloat16)
    if variant == "pair2":
        out[0::2] = out[1::2]
    return out


def edge_geom(geom, py=roi_inner.PY):
    """The draws with rows where y0 == y1 and taps outside the patch's py
    rows (below, above, truncated from a negative fraction to 0, NaN to 0;
    for py < 32 also a tap past the patch but inside 0-31)."""
    geom = geom.clone()
    geom[:, 0, 1] = geom[:, 0, 0]  # y0 == y1: one entry, bf16((1 - w) + w)
    geom[0::4, 1, 0] = -1.0  # y0 below the patch: only the y1 tap
    geom[1::4, 2, 1] = float(py)  # y1 above it: only the y0 tap
    geom[2::4, 3, 0], geom[2::4, 3, 1] = py + 8.7, -3.0  # neither tap
    geom[3::4, 4, 0], geom[3::4, 4, 1] = -0.5, float("nan")  # both convert to 0
    geom[:, 5, 0], geom[:, 5, 1] = py - 1.0, 0.0  # the last row and the first
    if py < roi_inner.PY:
        geom[:, 6, 0], geom[:, 6, 1] = py + 2.0, py - 1.0  # y0 past the patch, inside 0-31
    return geom


@pytest.mark.parametrize("variant", roi_inner.VARIANTS)
def test_roi_inner_split_tap_model_matches_plain(variant):
    xint, wx, geom, patch = roi_inner.make_inputs(64, "cpu")
    for g in (geom, edge_geom(geom)):
        want = roi_inner.roi_inner_plain(xint, wx, g, patch, variant)
        assert torch.equal(split_tap_model(xint, wx, g, patch, variant), want)
        if variant in ("full", "pair2"):
            assert want.float().abs().sum() > 0


# ------------------------------------ P3's kernel arithmetic, as the card runs it
#
# csrc/roi_probes.cu runs P3 on P2's body: the top class from the resident
# patch, a small class (py, px) from its int8 patch copied in chunks of 8
# rows, the codes made f32 through 2^23's mantissa, columns x >= px zero;
# A fragments over ceil(py/16) k-steps of 16 rows with rows k >= py zero,
# and split taps masked at k >= py, so D0 and D1 each hold one exact
# product. The model below does exactly that, chunk by chunk, and is held
# bit-equal to the plain version.


def kernel_codes(codes):
    """int8 codes as f32 the kernel's way: (code + 128) as the low byte of
    2^23's bits, minus 2^23 + 128."""
    u = (codes.to(torch.int32) ^ -128) & 0xFF  # code + 128, as the kernel's byte XOR 0x80
    return (u | 0x4B000000).view(torch.float32) - 8388736.0


def dispatch_split_tap_model(meta, xint, wx, geom, patch_top, feats, variant):
    n = meta.shape[0]
    C, POOL = roi_inner.C, roi_inner.POOL
    b, fh, fwc = feats.shape
    f4 = feats.reshape(b, fh, fwc // C, C)
    m = meta[:, 0].long()
    cls = torch.full((n,), roi_dispatch.TOP_CI) if variant == "bare" else m[:, 2]
    x0 = xint[:, 0].long()
    y0 = roi_align.xla_to_int32(geom[..., 0])[..., None]
    y1 = roi_align.xla_to_int32(geom[..., 1])[..., None]
    w = geom[..., 2:3]
    out = torch.full((n, POOL, POOL * C), float("nan"), dtype=torch.bfloat16)
    for ci, (py, px) in enumerate(roi_dispatch.CLASSES):
        rows = torch.nonzero(cls == ci).flatten()
        if rows.numel() == 0:
            continue
        k = rows.numel()
        ks = -(-py // 16)  # k-steps of the product
        xb = torch.zeros((k, 16 * ks, POOL, C), dtype=torch.bfloat16)  # rows k >= py zero
        wq = wx[rows, 0][:, None, :, None]
        for c in range(py // 8):  # the copy chunks, 8 patch rows each
            if ci == roi_dispatch.TOP_CI:
                src = patch_top.float().reshape(1, 32, 32, C)[:, 8 * c:8 * c + 8].expand(
                    k, -1, -1, -1)
            else:  # the whole [8, px] chunk, then columns past px read zero
                mm = m[rows]
                r = 8 * mm[:, 3, None, None] + 8 * c + torch.arange(8)[None, :, None]
                x = mm[:, 4, None, None] + torch.arange(px)[None, None, :]
                chunk = kernel_codes(f4[mm[:, 0, None, None], r, x])
                src = torch.cat([chunk, torch.zeros(k, 8, 32 - px, C)], dim=2)
            take = lambda xx: torch.gather(src, 2, xx[rows][:, None, :, None].expand(k, 8, POOL, C))
            xb[:, 8 * c:8 * c + 8] = ((1.0 - wq) * take(x0) + wq * take(x0 + 1)).to(torch.bfloat16)
        kk = torch.arange(16 * ks)
        g0, g1, gw = y0[rows], y1[rows], w[rows]
        zero = torch.zeros(())
        wy = (torch.where(kk == g0, 1.0 - gw, zero) + torch.where(kk == g1, gw, zero)).to(
            torch.bfloat16)
        inside = kk < py
        tap0 = torch.where(inside & (kk == g0), wy, torch.zeros((), dtype=torch.bfloat16))
        tap1 = torch.where(inside & (kk == g1) & (g1 != g0), wy,
                           torch.zeros((), dtype=torch.bfloat16))
        xf = xb.reshape(k, 16 * ks, POOL * C).float()
        d0, d1 = torch.bmm(tap0.float(), xf), torch.bmm(tap1.float(), xf)
        out[rows] = (d0 + d1).to(torch.bfloat16)
    return out


def dispatch_model_case(case):
    """(inputs, variant) of a model case: a variant of the TPU script's
    inputs; one (level, class) pair; the mixed run; a class with edge taps
    and blend columns at and past its last column."""
    if case in roi_dispatch.VARIANTS:
        return roi_dispatch.make_inputs(case, 64, "cpu"), case
    if case == "mixed":
        return roi_dispatch.make_mixed_inputs(176, "cpu"), "dispatch"
    kind, ci = case.split("_")
    ci = int(ci)  # class ci at level ci: class 3, the top class, at the top level
    args = list(roi_dispatch.make_mixed_inputs(64, "cpu", seed=2 + ci, kinds=[(ci, ci)]))
    if kind == "edge":
        py = roi_dispatch.CLASSES[ci][0]
        args[3] = edge_geom(args[3], py)
        xint = args[1].clone()
        xint[0::3, 0, 0] = min(py, 30)  # both columns at or past px: zero for a small class
        xint[1::3, 0, 1] = min(py - 1, 30)  # x1 = px: the second column zero
        xint[2::3, 0, 2] = 30  # the last blend the probe allows
        args[1] = xint
    return tuple(args), "dispatch"


@pytest.mark.parametrize("case", [
    "bare", "dispatch", "dispatch_small", "class_0", "class_1", "class_2", "mixed",
    "edge_0", "edge_1", "edge_2", "edge_3"])
def test_roi_dispatch_split_tap_model_matches_plain(case):
    args, variant = dispatch_model_case(case)
    want = roi_dispatch.roi_dispatch_plain(*args, variant)
    got = dispatch_split_tap_model(*args, variant)
    assert torch.equal(got, want)
    assert want.float().abs().sum() > 0
    if case == "mixed":  # every kind of mixed_kinds(), each inside its source
        assert {tuple(r) for r in args[0][:, 0, 1:3].tolist()} == set(roi_dispatch.mixed_kinds())


def test_kernel_codes_are_exact():
    codes = torch.arange(-128, 128, dtype=torch.int8)
    assert torch.equal(kernel_codes(codes), codes.float())


def test_device_ms_profiles_an_empty_window_once_more(monkeypatch):
    """A profiled window with no kernel record is taken again; two empty
    windows raise."""
    from types import SimpleNamespace

    cuda = torch.autograd.DeviceType.CUDA
    windows = []

    class Profile:
        def __init__(self, **kw):
            self.events = windows.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    calls = []
    kernel = SimpleNamespace(key="k", device_type=cuda, count=4, self_device_time_total=8000.0)
    windows[:] = [[], [kernel]]
    assert common.device_ms(lambda: calls.append(1), reps=4) == pytest.approx(2.0)
    assert len(calls) == 1 + 4 + 4  # a warm-up call and two windows
    windows[:] = [[], []]
    with pytest.raises(RuntimeError, match="no device time"):
        common.device_ms(lambda: None, reps=4)


def test_per_call_ms_survives_a_lost_record():
    """The profiler can drop a kernel record; the device time a call keeps
    the mean of the records it has, times the launches a call makes."""
    from types import SimpleNamespace

    cuda = torch.autograd.DeviceType.CUDA
    rec = lambda key, count, us: SimpleNamespace(key=key, device_type=cuda, count=count,
                                                 self_device_time_total=us)
    prof = SimpleNamespace(key_averages=lambda: [
        rec("probe", 4, 4 * 2000.0),  # 5 calls, one record lost
        rec("pair", 9, 9 * 10.0),  # two launches a call, one record lost
        rec("fill", 5, 5 * 1.0),
        SimpleNamespace(key="cpu op", device_type=torch.autograd.DeviceType.CPU, count=5,
                        self_device_time_total=0.0),
    ])
    got = common.per_call_ms(prof, 5)
    assert got == pytest.approx({"probe": 2.0, "pair": 0.02, "fill": 0.001})
