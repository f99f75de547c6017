"""Fused int8 ResNet identity bottleneck: plain PyTorch version and CUDA kernel.

Port of ``objectdetection_tpu/ops/fused_block.py`` (``fused_identity_block_int8``
and its Pallas ``_kernel``), whose CUDA counterpart is ``csrc/fused_block.cu``.
One call runs a whole int8 identity block on the carried stream:

    t1 = x · Ka                      (1×1, exact int32)
    m1 = min(rint(max(f32(t1)·α_a + β_a, 0)), 127)          int8
    t2 = 3×3 conv of m1 by Kb        (SAME: m1 is zero outside the image)
    m2 = min(rint(max(f32(t2)·α_b + β_b, 0)), 127)          int8
    t3 = m2 · Kc
    y  = min(rint(max(f32(t3)·α_c + β_c + f32(x)·sc, 0)), 127)   int8

with the dequant, conv bias, folded BatchNorm and the requant to the next
conv's calibrated scale folded into one affine per conv (:func:`block_affines`,
in the JAX wrapper's expression order; on the card the preparation kernel of
:func:`prepare` computes the same f32 operations in the same order). rint
rounds half to even, as ``jnp.round``. The kernel and the plain version
compute the same f32 operations on the same values, so they are bit-equal; the
unfused int8 block (``QuantConv`` + BatchNorm in the compute dtype) rounds
in other places and differs by up to about one int8 step.

:func:`fused_block_supported` is the JAX gate, copied with its TPU tiling
rule (``pick_tile``): it decides which blocks fuse, and fused and unfused
blocks differ in their low bits, so the port fuses exactly the blocks JAX
fuses. The CUDA kernel tiles otherwise: :func:`tile_plan` gives each block
of the grid a 2D tile of output pixels with a one-pixel halo, sized from
the shapes alone (no shared buffer grows with the width).

On the CPU the wrapper runs the plain version; on the card it launches the
kernel or raises. Inference only.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from objectdetection_torch import quant as Q
from objectdetection_torch.ops import cuda_build

_BLOCK = cuda_build.Entry("fused_block", "fused_block_int8", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    name="fused_block")
_PREP = cuda_build.Entry("fused_block", "fused_block_prep",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3)

TH = 32  # the Pallas kernel's row-tile height (the gate's tiling rule)
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on Hopper


def pick_tile(h: int) -> int:
    """Largest tile height (<= TH) giving >= 2 tiles, or 0 if unsupported."""
    for th in (TH, 16, 8):
        if h % th == 0 and h // th >= 2:
            return th
    return 0


def fused_block_supported(x8: torch.Tensor, c1: int) -> bool:
    """The JAX gate: an int8 [B, H, W, C3] input with a tileable height
    (>= 2 row tiles), a 128-multiple W·C3 and 64-multiple bottleneck width."""
    if x8.dim() != 4 or x8.dtype != torch.int8:
        return False
    _, h, w, c3 = x8.shape
    return pick_tile(h) > 0 and (w * c3) % 128 == 0 and c1 % 64 == 0 and w >= 3


NWARPS = 8  # warps per block
# 16x32 accumulator tiles a warp and conv: 2 (at most 128 registers a
# thread: two blocks a SM where their shared bytes fit) or 4 (one block)
JMAXES = (2, 4)
SMEM_SM = 233472  # shared memory of one SM, of which 1 KB is reserved a block
KCHS = (128, 64, 32)  # bytes of K per weight chunk, the widest that fits first
FILL = 128  # blocks that fill the card (132 SMs)
# output tiles (rows, columns), largest first; conv 2a runs on the halo,
# (th+2)(tw+2)/(th·tw) of its necessary MACs: 1.41, 1.56, 1.88 (2.25 for
# the last, taken only where no other fits)
TILES = ((8, 16), (8, 8), (4, 8))
FALLBACK_TILE = (4, 4)
# the fields of a plan, in the order of csrc/fused_block.cu's struct Plan
PLAN_FIELDS = ("th", "tw", "na", "nb", "nc", "kca", "kcb", "kcc", "wa_ld", "wb_ld", "wc_ld",
               "x_ld", "m1_ld", "m2_ld", "x_off", "m1_off", "m2_off", "w_off", "ab_off",
               "smem", "tiles_h", "tiles_w", "jmax")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def warps_needed(rows: int, nch: int, jmax: int) -> int:
    """Warps a conv of ``rows`` pixel rows and an N chunk of ``nch`` takes
    in the kernel: each warp owns tm 16-row tiles × tn 32-channel groups
    (tm = min(jmax, row tiles), tm·tn = jmax)."""
    mt = _ceil(rows, 16)
    tm = min(jmax, mt)
    return _ceil(mt, tm) * _ceil(nch // 32, jmax // tm)


def _plan_for(b: int, h: int, w: int, c3: int, c1: int, th: int, tw: int,
              jmax: int = 4) -> dict:
    """The layout of one tile shape. Each conv's N chunk is the widest
    (32·2^i, up to its N) that the block's warps cover with jmax 16x32
    accumulator tiles each (``warps_needed``): more tiles a warp means more
    independent products between two barriers. Rows are padded by 16 bytes
    (ldmatrix reads 8 rows without bank conflicts); the shared regions lie
    back to back: the staged input, m1, m2, two weight-ring stages and two
    N chunks' f32 affines, in the bytes of one block a SM (jmax 4) or two
    (jmax 2). Each conv's N and K chunk (KCHS) fill a ring stage, widest N
    first; Ka and Kc, read in place as rows of their OIHW storage, take K
    chunks of 64 bytes or more where any fits (a 32-byte piece a row
    scatters a warp's copies over 16 rows), while the packed Kb is one
    contiguous block a chunk."""
    p1 = (th + 2) * (tw + 2)

    def widest(rows: int, n: int) -> int:
        c = 32
        while warps_needed(rows, c * 2, jmax) <= NWARPS and c * 2 <= _ceil(n, 32) * 32:
            c *= 2
        return c

    plan = dict(th=th, tw=tw, x_ld=_ceil(c3, 32) * 32 + 16, m1_ld=c1 + 16, m2_ld=c1 + 16,
                tiles_h=_ceil(h, th), tiles_w=_ceil(w, tw), jmax=jmax)
    fixed = p1 * plan["x_ld"] + p1 * plan["m1_ld"] + th * tw * plan["m2_ld"]
    widths = {"a": (widest(p1, c1), True), "b": (widest(th * tw, c1), False),
              "c": (widest(th * tw, c3), True)}
    limit = SMEM_SM // 2 - 1024 if jmax == 2 else SMEM_LIMIT
    stage = (limit - fixed - 2 * 2 * max(n for n, _ in widths.values()) * 4) // 2
    for conv, (n, in_place) in widths.items():
        ns = [n >> i for i in range(5) if n >> i >= 32]
        opts = [(m, k) for m in ns for k in KCHS if not (in_place and k == 32)]
        opts += [(m, 32) for m in ns] if in_place else []
        m, k = next(((m, k) for m, k in opts if m * (k + 16) <= stage), (32, 32))
        plan.update({f"n{conv}": m, f"kc{conv}": k, f"w{conv}_ld": k + 16})
    nmax = max(plan["na"], plan["nb"], plan["nc"])
    off = 0
    for name, size in (("x", p1 * plan["x_ld"]), ("m1", p1 * plan["m1_ld"]),
                       ("m2", th * tw * plan["m2_ld"]),
                       ("w", 2 * max(plan[f"n{c}"] * plan[f"w{c}_ld"] for c in "abc")),
                       ("ab", 2 * 2 * nmax * 4)):
        plan[f"{name}_off"] = off
        off += size
    plan["smem"] = off
    plan["grid"] = b * plan["tiles_h"] * plan["tiles_w"]
    plan["per_sm"] = 2 if jmax == 2 and 2 * (off + 1024) <= SMEM_SM else 1
    plan["halo"] = p1 / (th * tw)
    return plan


def tile_plan(b: int, h: int, w: int, c3: int, c1: int) -> dict:
    """The kernel's launch plan for a [b, h, w, c3] input and bottleneck
    width c1: the output tile (th, tw), the N chunks of convs 2a, 2b and 2c
    (na, nb, nc) and their K chunks (kca, kcb, kcc), the shared row strides
    and regions and their bytes (smem), the accumulator tiles a warp
    (jmax), the grid (b · tiles_h · tiles_w blocks), the blocks a SM
    (per_sm) and conv 2a's halo factor. The largest tile of ``TILES`` that
    fits and gives ``FILL`` blocks a resident block slot; else the one of
    them with the most blocks; ``FALLBACK_TILE`` where none fits. Raises
    ValueError where no tile fits (C3 above ~6000) or C3 is not a multiple
    of 16 (16-byte rows)."""
    if c3 % 16 or c1 % 32 or min(b, h, w, c3, c1) <= 0:
        raise ValueError(f"fused_block: no plan for C3={c3}, C1={c1} (16 | C3, 32 | C1)")
    fits = []
    for th, tw in TILES:  # two blocks a SM (jmax 2) where they fit, else one (jmax 4)
        two, one = (_plan_for(b, h, w, c3, c1, th, tw, j) for j in JMAXES)
        p = two if two["per_sm"] == 2 else one
        if p["smem"] <= SMEM_LIMIT:
            fits.append(p)
    for p in fits:
        if p["grid"] >= FILL * p["per_sm"]:
            return p
    if fits:
        return max(fits, key=lambda p: p["grid"])
    p = _plan_for(b, h, w, c3, c1, *FALLBACK_TILE)
    if p["smem"] > SMEM_LIMIT:
        raise ValueError(f"fused_block: C3={c3}, C1={c1} exceed the kernel's shared memory")
    return p


def block_affines(in_scale, sw_a, sw_b, sw_c, bias_a, bias_b, bias_c, bn_a, bn_b, bn_c,
                  scale_b, scale_c, out_scale) -> Tuple[torch.Tensor, ...]:
    """(α_a, β_a, α_b, β_b, α_c, β_c, sc_short), f32, in the JAX wrapper's
    order (fused_block.py:291-310): relu commutes with the positive requant
    scale, so e.g. α_a = s_x/127 · s_w · inv · 127/s_b."""
    f32 = lambda v: v.to(torch.float32)
    dev = f32(sw_a).device
    qmax = torch.tensor(Q.ACT_QMAX, dtype=torch.float32, device=dev)
    sxa = f32(in_scale) / qmax
    r_b = qmax / torch.clamp(f32(scale_b), min=1e-30)
    r_c = qmax / torch.clamp(f32(scale_c), min=1e-30)
    r_o = qmax / torch.clamp(f32(out_scale), min=1e-30)
    (inv_a, shift_a), (inv_b, shift_b), (inv_c, shift_c) = (
        (f32(i), f32(s)) for i, s in (bn_a, bn_b, bn_c))
    alpha_a = sxa * f32(sw_a) * inv_a * r_b
    beta_a = (f32(bias_a) * inv_a + shift_a) * r_b
    alpha_b = f32(scale_b) / qmax * f32(sw_b) * inv_b * r_c
    beta_b = (f32(bias_b) * inv_b + shift_b) * r_c
    alpha_c = f32(scale_c) / qmax * f32(sw_c) * inv_c * r_o
    beta_c = (f32(bias_c) * inv_c + shift_c) * r_o
    sc_short = sxa * r_o
    return alpha_a, beta_a, alpha_b, beta_b, alpha_c, beta_c, sc_short


def _requant(t: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(t.to(torch.float32) * alpha + beta, min=0.0)
    return torch.clamp(torch.round(v), max=127.0).to(torch.int8)


def fused_identity_block_int8_plain(x8, in_scale, ka8, kb8, kc8, sw_a, sw_b, sw_c,
                                    bias_a, bias_b, bias_c, bn_a, bn_b, bn_c,
                                    scale_b, scale_c, out_scale) -> torch.Tensor:
    """The block in PyTorch: exact integer convs (``quant.int8_conv``) and
    the kernel's f32 epilogues. Arguments as :func:`fused_identity_block_int8`."""
    aa, ba, ab, bb, ac, bc, sc = block_affines(
        in_scale, sw_a, sw_b, sw_c, bias_a, bias_b, bias_c, bn_a, bn_b, bn_c,
        scale_b, scale_c, out_scale)
    oihw = lambda k: k.permute(3, 2, 0, 1)
    m1 = _requant(Q.int8_conv(x8, oihw(ka8)), aa, ba)
    m2 = _requant(Q.int8_conv(m1, oihw(kb8)), ab, bb)
    t3 = Q.int8_conv(m2, oihw(kc8))
    v = torch.clamp(t3.to(torch.float32) * ac + bc + x8.to(torch.float32) * sc, min=0.0)
    return torch.clamp(torch.round(v), max=127.0).to(torch.int8)


def fused_identity_block_int8(
    x8: torch.Tensor,  # [B, H, W, C3] int8, NHWC
    in_scale: torch.Tensor,  # the block input's scale (scalar)
    ka8: torch.Tensor,  # [1, 1, C3, C1] int8 frozen kernel (HWIO, as JAX)
    kb8: torch.Tensor,  # [3, 3, C1, C1]
    kc8: torch.Tensor,  # [1, 1, C1, C3]
    sw_a: torch.Tensor,  # [C1] per-channel weight scales
    sw_b: torch.Tensor,
    sw_c: torch.Tensor,
    bias_a: torch.Tensor,  # conv biases
    bias_b: torch.Tensor,
    bias_c: torch.Tensor,
    bn_a: tuple,  # (inv, shift) folded FrozenBatchNorm affines
    bn_b: tuple,
    bn_c: tuple,
    scale_b: torch.Tensor,  # conv 2b's calibrated input scale (m1's range)
    scale_c: torch.Tensor,  # conv 2c's calibrated input scale (m2's range)
    out_scale: torch.Tensor,  # the block's calibrated output scale
) -> torch.Tensor:
    """One int8 identity bottleneck block, fused: int8 [B, H, W, C3]
    quantized with ``out_scale`` (the carried stream of the backbone)."""
    args = (x8, in_scale, ka8, kb8, kc8, sw_a, sw_b, sw_c, bias_a, bias_b, bias_c,
            bn_a, bn_b, bn_c, scale_b, scale_c, out_scale)
    if not cuda_build.takes_kernel(x8, "fused_block"):
        return fused_identity_block_int8_plain(*args)
    b, h, w, c3 = x8.shape
    c1 = ka8.shape[-1]
    if not fused_block_supported(x8, c1):
        raise ValueError(f"fused_block: unsupported input {tuple(x8.shape)}, C1={c1}")
    if (tuple(ka8.shape) != (1, 1, c3, c1) or tuple(kb8.shape) != (3, 3, c1, c1)
            or tuple(kc8.shape) != (1, 1, c1, c3)
            or any(k.dtype != torch.int8 for k in (ka8, kb8, kc8))):
        raise ValueError("fused_block: kernels must be int8 HWIO [1,1,C3,C1], "
                         "[3,3,C1,C1], [1,1,C1,C3]")
    plan = tile_plan(max(b, 1), h, w, c3, c1)
    x = x8.contiguous()
    out = torch.empty_like(x)
    if b == 0:
        return out
    aff, ka, kb, kc = prepare(x.device, plan["kcb"], in_scale, ka8, kb8, kc8, sw_a, sw_b, sw_c,
                              bias_a, bias_b, bias_c, bn_a, bn_b, bn_c, scale_b, scale_c,
                              out_scale)
    plan_arr = (ctypes.c_int * len(PLAN_FIELDS))(*[plan[f] for f in PLAN_FIELDS])
    _BLOCK.launch(x.device, x.data_ptr(), ka.data_ptr(), ka.stride(0), kb.data_ptr(),
                  kc.data_ptr(), kc.stride(0), aff.data_ptr(), out.data_ptr(), b, h, w, c3, c1,
                  plan_arr)
    return out


def prepare(dev, kch, in_scale, ka8, kb8, kc8, sw_a, sw_b, sw_c, bias_a, bias_b, bias_c,
            bn_a, bn_b, bn_c, scale_b, scale_c, out_scale):
    """The kernel's operands, from one launch of the preparation kernel on
    ``dev``: (aff, ka, kb, kc). aff: f32 [α_a, β_a, α_b, β_b (C1 each), α_c,
    β_c (C3 each), sc], :func:`block_affines` computed in its expression
    order; kb: Kb packed OHWI in chunks of kch bytes of K, [⌈9·C1/kch⌉, C1,
    kch] (each chunk of the block kernel's walk one contiguous block, the
    tail past 9·C1 unwritten and never read); ka [C1, C3] and kc [C3, C1] as
    [N][K] rows with K contiguous: the HWIO views of OIHW storage that the
    backbone passes, in place; other layouts packed by the same launch."""
    c1, c3 = kb8.shape[-1], kc8.shape[-1]
    vec = lambda v: v.to(device=dev, dtype=torch.float32).contiguous()
    vals = [vec(v) for v in (in_scale, sw_a, sw_b, sw_c, bias_a, bias_b, bias_c, *bn_a, *bn_b,
                             *bn_c, scale_b, scale_c, out_scale)]
    counts = (1, c1, c1, c3, c1, c1, c3, c1, c1, c1, c1, c3, c3, 1, 1, 1)
    if any(v.numel() != n for v, n in zip(vals, counts)):
        raise ValueError("fused_block: the act scales must be scalars, the weight scales, "
                         "biases and BatchNorm affines vectors [C1] or [C3]")
    ones = [ka8[0, 0].t(), kc8[0, 0].t()]
    direct = [k.stride(1) == 1 and k.stride(0) % 16 == 0 and k.data_ptr() % 16 == 0
              for k in ones]
    nkb = _ceil(9 * c1, kch)
    scratch = torch.empty(nkb * c1 * kch + sum(k.numel() for k, d in zip(ones, direct) if not d),
                          dtype=torch.int8, device=dev)
    aff = torch.empty(4 * c1 + 2 * c3 + 1, dtype=torch.float32, device=dev)
    kb = scratch[:nkb * c1 * kch].view(nkb, c1, kch)
    mats, ptrs, kstrides, at = [], [], list(kb8.stride()), nkb * c1 * kch
    for k, d in zip(ones, direct):
        if d:
            mats.append(k)
            ptrs += [None, None]
            kstrides += [0, 0]
        else:
            packed = scratch[at:at + k.numel()].view(k.shape)
            mats.append(packed)
            ptrs += [k.data_ptr(), packed.data_ptr()]
            kstrides += list(k.stride())
            at += k.numel()
    ptr_arr = (ctypes.c_void_p * 22)(*[v.data_ptr() for v in vals], kb8.data_ptr(),
                                      kb.data_ptr(), *ptrs)
    kstr = (ctypes.c_longlong * 8)(*kstrides)
    _PREP.launch(dev, ptr_arr, kstr, aff.data_ptr(), c3, c1, kch)
    return aff, mats[0], kb, mats[1]


def block_bound(b: int, h: int, w: int, c3: int, c1: int) -> Tuple[int, int]:
    """(operations, bytes) one call must do and move: 2 per MAC of the three
    convs, without recomputing halos; the int8 input read once, the output
    written once, the three kernels read once."""
    macs = b * h * w * (c3 * c1 + 9 * c1 * c1 + c1 * c3)
    moved = 2 * b * h * w * c3 + (2 * c3 * c1 + 9 * c1 * c1) + 4 * (4 * c1 + 2 * c3)
    return 2 * macs, moved
