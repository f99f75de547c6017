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


# ---------------------------------------------------------------- the CUDA kernel's tile walk

# the ResNet stages of a 1024² batch of 2 (tools/torch_kernel_cases.py STAGES):
# the tile and the number of blocks that PERF.md states for each
STAGE_PLANS = {
    (2, 256, 256, 256, 64): ((8, 16), 1024),
    (2, 128, 128, 512, 128): ((8, 16), 256),
    (2, 64, 64, 1024, 256): ((8, 8), 128),
    (2, 32, 32, 2048, 512): ((4, 8), 64),
}


@pytest.mark.parametrize("b,h,w,c3,c1", [
    *STAGE_PLANS,
    # the card tests' shapes
    (2, 64, 64, 256, 64), (2, 16, 16, 1024, 256), (2, 16, 8, 2048, 512),
    (1, 256, 256, 256, 64), (1, 128, 128, 512, 128), (1, 64, 64, 1024, 256),
    (1, 32, 32, 2048, 512), (3, 16, 16, 256, 64),
    # ragged: W = 3, W = 12, H = 16 over two row tiles with a ragged last
    # column tile; W·C3 = 131072
    (1, 16, 3, 128, 64), (1, 16, 12, 32, 64), (1, 16, 2044, 64, 64), (1, 16, 512, 256, 64),
])
def test_tile_plan_covers_every_pixel_once(b, h, w, c3, c1):
    p = tfb.tile_plan(b, h, w, c3, c1)
    th, tw = p["th"], p["tw"]
    assert p["grid"] == b * p["tiles_h"] * p["tiles_w"]
    seen = np.zeros((b, h, w), np.int32)
    for blk in range(p["grid"]):
        bi, ti = divmod(blk, p["tiles_h"] * p["tiles_w"])
        y0, x0 = (ti // p["tiles_w"]) * th, (ti % p["tiles_w"]) * tw
        assert y0 < h and x0 < w  # no block without an output pixel
        seen[bi, y0:y0 + th, x0:x0 + tw] += 1
    assert (seen == 1).all()
    # the staged input and m1 hold the tile and a one-pixel ring, no more
    p1 = (th + 2) * (tw + 2)
    assert p["m1_off"] - p["x_off"] == p1 * p["x_ld"]
    assert p["m2_off"] - p["m1_off"] == p1 * p["m1_ld"]
    assert p["x_ld"] >= c3 and p["m1_ld"] >= c1 and p["m2_ld"] >= c1
    nmax = max(p["na"], p["nb"], p["nc"])
    assert all(p[f"w{c}_ld"] >= p[f"kc{c}"] for c in "abc")
    assert p["ab_off"] - p["w_off"] == 2 * max(p[f"n{c}"] * p[f"w{c}_ld"] for c in "abc")
    assert p["ab_off"] + 2 * 2 * nmax * 4 == p["smem"]
    assert p["smem"] <= tfb.SMEM_LIMIT
    assert all(p[f] % 16 == 0 for f in ("x_ld", "m1_ld", "m2_ld", "wa_ld", "wb_ld", "wc_ld",
                                        "x_off", "m1_off", "m2_off", "w_off", "ab_off"))
    # the block's warps cover each conv's N chunk with jmax 16x32 tiles each
    assert p["per_sm"] * (p["smem"] + 1024) <= tfb.SMEM_SM
    assert tfb.warps_needed(p1, p["na"], p["jmax"]) <= tfb.NWARPS
    assert tfb.warps_needed(th * tw, max(p["nb"], p["nc"]), p["jmax"]) <= tfb.NWARPS
    assert p["halo"] == p1 / (th * tw) and p["halo"] <= 2
    if (b, h, w, c3, c1) == (1, 16, 2044, 64, 64):
        assert p["tiles_h"] == 2 and w % tw
    if (b, h, w, c3, c1) in STAGE_PLANS:
        assert ((th, tw), p["grid"]) == STAGE_PLANS[(b, h, w, c3, c1)]
        assert p["halo"] <= (1.6 if c1 < 512 else 2.0)


def test_tile_plan_refuses_what_no_tile_holds():
    p = tfb.tile_plan(2, 64, 64, 4096, 64)  # no tile of TILES holds 100 rows of 4 KB
    assert (p["th"], p["tw"]) == tfb.FALLBACK_TILE
    with pytest.raises(ValueError, match="shared memory"):
        tfb.tile_plan(1, 8, 8, 8192, 64)
    with pytest.raises(ValueError, match="no plan"):
        tfb.tile_plan(1, 8, 16, 40, 64)


def _walk(x8, ka8, kb8, kc8, affines, p):
    """A model of csrc/fused_block.cu's walk: block by block over the plan's
    tiles; conv 2a on the tile's halo (input zero outside the image and in the
    K padding to 32), m1 zeroed outside the image, conv 2b over the nine
    shifted halo rows, conv 2c with the shortcut from the staged input; each
    conv in N chunks (na, nb, nc) and K chunks (kca, kcb, kcc) of [N][K] weight
    rows."""
    aa, ba, ab, bb, ac, bc, sc = affines
    b, h, w, c3 = x8.shape
    c1 = ka8.shape[-1]
    th, tw = p["th"], p["tw"]
    hw, p1 = tw + 2, (th + 2) * (tw + 2)
    c3p = -(-c3 // 32) * 32
    ka = ka8[0, 0].t().long()  # [C1][C3]
    kb = kb8.permute(3, 0, 1, 2).reshape(c1, 9 * c1).long()  # OHWI
    kc = kc8[0, 0].t().long()  # [C3][C1]

    def gemm(a, wt, n, nch, kch, epilogue):
        k = a.shape[1]
        for n0 in range(0, n, nch):
            acc = torch.zeros(a.shape[0], min(nch, n - n0), dtype=torch.long)
            for k0 in range(0, k, kch):
                kk = min(kch, k - k0)
                wk = torch.zeros(acc.shape[1], kk, dtype=torch.long)
                have = max(0, min(kk, wt.shape[1] - k0))  # K beyond the rows reads 0
                wk[:, :have] = wt[n0:n0 + nch, k0:k0 + have]
                acc += a[:, k0:k0 + kk] @ wk.t()
            epilogue(n0, acc)

    out = torch.empty_like(x8)
    for blk in range(p["grid"]):
        bi, ti = divmod(blk, p["tiles_h"] * p["tiles_w"])
        y0, x0 = (ti // p["tiles_w"]) * th, (ti % p["tiles_w"]) * tw
        hy, hx = [r.reshape(-1) for r in torch.meshgrid(
            torch.arange(th + 2) + y0 - 1, torch.arange(tw + 2) + x0 - 1, indexing="ij")]
        inside = (hy >= 0) & (hy < h) & (hx >= 0) & (hx < w)
        xs = torch.zeros(p1, c3p, dtype=torch.long)
        xs[inside, :c3] = x8[bi, hy[inside], hx[inside]].long()
        m1 = torch.zeros(p1, c1, dtype=torch.long)

        def ep_a(n0, t):
            m = tfb._requant(t, aa[n0:n0 + t.shape[1]], ba[n0:n0 + t.shape[1]]).long()
            m1[:, n0:n0 + t.shape[1]] = torch.where(inside[:, None], m, 0)

        gemm(xs, ka, c1, p["na"], p["kca"], ep_a)
        r = torch.arange(th * tw)
        base = (r // tw) * hw + r % tw
        cols = torch.cat([m1[base + dy * hw + dx] for dy in range(3) for dx in range(3)], 1)
        m2 = torch.zeros(th * tw, c1, dtype=torch.long)

        def ep_b(n0, t):
            m2[:, n0:n0 + t.shape[1]] = tfb._requant(t, ab[n0:n0 + t.shape[1]],
                                                     bb[n0:n0 + t.shape[1]]).long()

        gemm(cols, kb, c1, p["nb"], p["kcb"], ep_b)
        interior = base + hw + 1
        y = torch.zeros(th * tw, c3, dtype=torch.int8)

        def ep_c(n0, t):
            s = slice(n0, n0 + t.shape[1])
            v = t.to(torch.float32) * ac[s] + bc[s] + xs[interior, s].to(torch.float32) * sc
            y[:, s] = torch.clamp(torch.round(torch.clamp(v, min=0.0)), max=127.0).to(torch.int8)

        gemm(m2, kc, c3, p["nc"], p["kcc"], ep_c)
        oy, ox = y0 + r // tw, x0 + r % tw
        keep = (oy < h) & (ox < w)
        out[bi, oy[keep], ox[keep]] = y[keep]
    return out


@pytest.mark.parametrize("jmax", tfb.JMAXES)
@pytest.mark.parametrize("tile", [*tfb.TILES, tfb.FALLBACK_TILE])
@pytest.mark.parametrize("b,h,w,c3,c1", [
    (1, 10, 3, 48, 64),  # W = 3, C3 padded to 64 in K
    (2, 9, 13, 256, 128),  # ragged rows and columns, two N chunks in conv 2c
])
def test_kernel_walk_matches_plain(tile, jmax, b, h, w, c3, c1):
    case = make_case(np.random.RandomState(11), b, h, w, c3, c1)
    a = args(case, lambda v: torch.from_numpy(np.array(v)))
    p = tfb._plan_for(b, h, w, c3, c1, *tile, jmax)
    affines = tfb.block_affines(*a[1:2], *a[5:])
    got = _walk(a[0], a[2], a[3], a[4], affines, p)
    want = tfb.fused_identity_block_int8_plain(*a)
    assert int((want != 0).sum()) > want.numel() // 4  # the block is not all clipped
    assert torch.equal(got, want)
