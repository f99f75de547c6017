// Fused int8 ResNet identity bottleneck block (int8 serving path).
//
// Replaces the Pallas TPU kernel objectdetection_tpu/ops/fused_block.py
// `_kernel` (entered through `fused_identity_block_int8`). It computes what
// that kernel computes, not its DMA choreography: for an int8 NHWC input x
// (the carried stream) and int8 kernels Ka (1x1, C3->C1), Kb (3x3, C1->C1),
// Kc (1x1, C1->C3),
//   t1 = x.Ka (int32)     m1 = min(rint(max(f32(t1)*aa + ba, 0)), 127)
//   t2 = 3x3(m1, Kb)      m2 = min(rint(max(f32(t2)*ab + bb, 0)), 127)
//   t3 = m2.Kc            y  = min(rint(max(f32(t3)*ac + bc + f32(x)*sc, 0)), 127)
// m1 is zero outside the image (SAME padding of the 3x3's input). Every
// epilogue operation is explicitly rounded (--fmad=false), so the result is
// bit-equal to the plain PyTorch version; the integer products are exact
// (the largest sum, 9*512*127*128, is below 2^31).
//
// What bounds it on the H100: per call it must read the int8 input and write
// the int8 output once (2 x 33.6 MB at B=2 in R101's stage 2 at 1024^2, half
// that per later stage) against 9.13 GMAC of int8 work at every stage (~9 us
// at the int8 tensor-core peak): bytes in stages 2-3, operations in 4-5
// (ops/fused_block.py `block_bound`). What the design does about each:
//
// - Tiles, not rows. One block (8 warps) owns a TH x TW tile of output
//   pixels of one image, chosen per call by ops/fused_block.py `tile_plan`
//   (8x16 at stages 2-3, 8x8 at stage 4, 4x8 at stage 5 for a 1024^2 batch
//   of 2: 1024 / 256 / 128 / 64 blocks). Conv 2a is recomputed only on the
//   one-pixel halo ((TH+2)(TW+2)/(TH*TW) = 1.41x, 1.56x, 1.88x), and no
//   buffer grows with the image width. The tile's input (halo included,
//   zero outside the image), m1 (halo) and m2 live in shared memory only;
//   the input is read from global memory once and its interior is the
//   shortcut, overwritten by the output tile, which leaves in 16-byte stores.
// - Operations on the int8 tensor cores. Each conv is an implicit GEMM on
//   mma.sync m16n8k32 s8. A fragments come from shared memory with ldmatrix
//   (conv 2a: input pixels; conv 2b: the nine shifted m1 views, K = (dy, dx,
//   ci), gathered by row address; conv 2c: m2); rows are padded by 16 bytes
//   so that ldmatrix's 8 rows meet no bank twice. A warp owns a fixed tile of
//   16-row x 32-channel accumulators (conv()), so its K loop has no branch.
// - Weights. B operands are K-major [N][K] rows: Ka and Kc read in place
//   from their OIHW storage, Kb packed once per call to OHWI in K chunks by
//   `fused_block_prep_kernel`, which also folds the affines on the device in
//   the plain version's expression order (`block_affines`). They stream
//   through a two-stage cp.async ring of [N chunk][K chunk] tiles with the
//   chunk's affines, each weight byte read once a tile from L2. Each conv's
//   N chunk is as wide as the warps' accumulators allow, so a barrier
//   brackets as many products as registers hold.
// - Filling the card. Stage 2 takes two blocks a SM (2 accumulator tiles a
//   warp, at most 128 registers a thread), the others one (4 tiles).
//
// Not used: wgmma, TMA, warp specialisation, clusters.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;  // threads per block
constexpr int PLAN_FIELDS = 23;

// the launch plan of ops/fused_block.py `tile_plan` (PLAN_FIELDS, in order)
struct Plan {
  int th, tw;     // output tile
  int na, nb, nc;     // N chunk of convs 2a, 2b and 2c
  int kca, kcb, kcc;  // their K chunks (bytes): 32, 64 or 128
  int wa_ld, wb_ld, wc_ld;     // their rows' strides in the weight ring (bytes)
  int x_ld, m1_ld, m2_ld;      // shared row strides (bytes)
  int x_off, m1_off, m2_off, w_off, ab_off;  // shared regions (bytes)
  int smem, tiles_h, tiles_w;  // block bytes; the grid is batch x tiles_h x tiles_w
  int jmax;  // 16x32 accumulator tiles a warp: 4, or 2 for two blocks a SM
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// min(rint(max(v, 0)), 127) as int8, rint rounding half to even: the
// conversion rounds as rint and saturates (+inf to INT_MAX), NaN gives 0
__device__ __forceinline__ int8_t to_code(float v) {
  return (int8_t)min(__float2int_rn(fmaxf(v, 0.0f)), 127);
}

__device__ __forceinline__ int8_t requant(int t, float a, float b) {
  return to_code(__fadd_rn(__fmul_rn(__int2float_rn(t), a), b));
}

struct Tile {
  int8_t* xs;    // [(TH+2)(TW+2)][x_ld]: the input with its halo, later the output
  int8_t* m1;    // [(TH+2)(TW+2)][m1_ld]
  int8_t* m2;    // [TH*TW][m2_ld]
  int8_t* ring;  // 2 x [nch][wrow] weight chunks
  float* ab;     // 2 x [alpha nch][beta nch]: the affines of an N chunk
  int H, W, C1, y0, x0;
};

enum { CONV_A = 0, CONV_B = 1, CONV_C = 2 };

// One conv of the block as an implicit GEMM over the TH x TW tile: rows are
// pixels (halo pixels for conv 2a, output pixels otherwise), N chunks of
// `nch` output channels, K chunks of kch bytes through a two-stage
// cp.async ring (the next chunk lands while this one is used); the chunk's
// affines ride with its first K chunk. wg: [N][K] rows, K-contiguous, row
// stride wld; ksrc: K held in wg; k: K walked (conv 2a: C3 rounded up to
// 32, the padding zero on both sides); wslab: bytes from one K chunk of wg
// to the next (kch for rows read in place, N*kch for weights packed chunk
// by chunk); wrow: a ring row's stride.
//
// A warp's work is a fixed tile of TM 16-row tiles x TN 32-channel groups
// (TM x TN = JMAX), so the K loop has no branch: each A fragment serves TN
// groups and each B fragment TM row tiles. Warps cover the row tiles first
// (ceil(MT / TM) warps a group set); slots past the last row tile or group
// compute on clamped addresses and are dropped by the epilogue.
template <int MODE, int TH, int TW, int JMAX>
__device__ __forceinline__ void conv(const Plan& p, const Tile& t, const int8_t* __restrict__ wg,
                                     int wld, size_t wslab, int n, int ksrc, int k, int nch,
                                     int kch, int wrow, const float* __restrict__ alpha,
                                     const float* __restrict__ beta, float sc) {
  constexpr int HW = TW + 2;  // halo row length
  constexpr int P1 = (TH + 2) * HW;
  constexpr int ROWS = MODE == CONV_A ? P1 : TH * TW;
  constexpr int MT = (ROWS + 15) / 16;
  constexpr int TM = MT < JMAX ? MT : JMAX;
  constexpr int TN = JMAX / TM;
  constexpr int WPG = (MT + TM - 1) / TM;  // warps a group set
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int groups = nch / 32;
  const int mt0 = (warp % WPG) * TM, g0 = (warp / WPG) * TN;  // this warp's first tiles
  const bool idle = g0 >= groups;
  const int8_t* abuf = MODE == CONV_A ? t.xs : MODE == CONV_B ? t.m1 : t.m2;
  const int ald = MODE == CONV_A ? p.x_ld : MODE == CONV_B ? p.m1_ld : p.m2_ld;
  const uint32_t abase = smem_u32(abuf), wbase = smem_u32(t.ring);
  const int wstage = nch * wrow;

  // this lane's ldmatrix row address (without the K offset) in each row tile
  uint32_t arow[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = min(mt0 + i, MT - 1) * 16 + (lane & 15);
    int row;
    if (MODE == CONV_A) row = min(r, P1 - 1);
    else if (MODE == CONV_B) row = (r / TW) * HW + r % TW;  // tap (0, 0) of pixel r
    else row = r;
    arow[i] = abase + row * ald + (lane >> 4) * 16;
  }
  // this lane's ldmatrix row (n) and column (k) inside each group's B tile
  uint32_t bcol[TN];
#pragma unroll
  for (int jn = 0; jn < TN; ++jn)
    bcol[jn] = (min(g0 + jn, groups - 1) * 32 + (lane & 7) + ((lane >> 4) << 3)) * wrow +
               ((lane >> 3) & 1) * 16;

  int acc[TM][TN][4][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jn = 0; jn < TN; ++jn)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][jn][u][v] = 0;

  const int cshift = __ffs(kch / 16) - 1;  // 16-byte copies a row: 2, 4 or 8
  const int nk = (k + kch - 1) / kch;
  const int steps = ((n + nch - 1) / nch) * nk;
  auto load = [&](int s) {
    const int nc = s / nk, kc = s - nc * nk;
    const int n0 = nc * nch, k0 = kc * kch;
    int8_t* dst = t.ring + (s & 1) * wstage;
    for (int i = threadIdx.x; i < nch << cshift; i += NT) {
      const int r = i >> cshift, c = i & ((1 << cshift) - 1);
      const bool ok = n0 + r < n && k0 + c * 16 < ksrc;
      cp16(dst + r * wrow + c * 16,
           ok ? wg + kc * wslab + (size_t)(n0 + r) * wld + c * 16 : wg, ok);
    }
    if (kc == 0) {  // the N chunk's affines, 4 floats a copy
      float* slot = t.ab + (nc & 1) * 2 * nch;
      for (int i = threadIdx.x; i < nch / 2; i += NT) {
        const int c = (i % (nch / 4)) * 4;
        const float* src = i < nch / 4 ? alpha : beta;
        cp16(slot + (i < nch / 4 ? 0 : nch) + c, src + n0 + c, n0 + c < n);
      }
    }
  };

  load(0);
  cp_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load(s + 1);
    cp_commit();
    cp_wait1();       // chunk s has landed (this thread's copies)
    __syncthreads();  // and everyone's
    const int nc = s / nk, kc = s - nc * nk;
    const int n0 = nc * nch, k0 = kc * kch;
    if (!idle) {
      const int ksteps = min(kch, k - k0) / 32;
      const uint32_t wst = wbase + (s & 1) * wstage;
      // conv 2b: the tap and input channel of K offset k0 (a chunk of at
      // most 128 bytes meets at most two taps, C1 being 64 or more)
      int tap = 0, ci = k0;
      if (MODE == CONV_B) {
        tap = k0 / t.C1;
        ci = k0 - tap * t.C1;
      }
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t aoff = k0 + ks * 32;
        if (MODE == CONV_B) {
          if (ci == t.C1) {
            ++tap;
            ci = 0;
          }
          aoff = ((tap / 3) * HW + tap % 3) * ald + ci;
          ci += 32;
        }
        uint32_t a[TM][4], b[TN][2][4];
#pragma unroll
        for (int i = 0; i < TM; ++i) ldsm4(arow[i] + aoff, a[i]);
#pragma unroll
        for (int jn = 0; jn < TN; ++jn)
#pragma unroll
          for (int h = 0; h < 2; ++h) ldsm4(wst + bcol[jn] + h * 16 * wrow + ks * 32, b[jn][h]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int jn = 0; jn < TN; ++jn)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mma_s8(acc[i][jn][2 * h], a[i], b[jn][h][0], b[jn][h][1]);
              mma_s8(acc[i][jn][2 * h + 1], a[i], b[jn][h][2], b[jn][h][3]);
            }
      }
    }
    if (kc == nk - 1 && !idle) {  // the chunk's last K: epilogue of N chunk n0
      const float* sa = t.ab + (nc & 1) * 2 * nch;
      const float* sb = sa + nch;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int jn = 0; jn < TN; ++jn) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int cl = (g0 + jn) * 32 + u * 8 + tig * 2;  // channel in the chunk
            const int c = n0 + cl;
            if (mt0 + i < MT && g0 + jn < groups && c < n) {
              const float2 al = *reinterpret_cast<const float2*>(sa + cl);
              const float2 be = *reinterpret_cast<const float2*>(sb + cl);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = (mt0 + i) * 16 + g + h * 8;
                const int v0 = acc[i][jn][u][2 * h], v1 = acc[i][jn][u][2 * h + 1];
                if (MODE == CONV_A) {
                  if (r < P1) {
                    const int yy = t.y0 - 1 + r / HW, xx = t.x0 - 1 + r % HW;
                    const bool in = yy >= 0 && yy < t.H && xx >= 0 && xx < t.W;
                    *reinterpret_cast<char2*>(t.m1 + r * p.m1_ld + c) =
                        in ? make_char2(requant(v0, al.x, be.x), requant(v1, al.y, be.y))
                           : make_char2(0, 0);
                  }
                } else if (MODE == CONV_B) {
                  *reinterpret_cast<char2*>(t.m2 + r * p.m2_ld + c) =
                      make_char2(requant(v0, al.x, be.x), requant(v1, al.y, be.y));
                } else {
                  // the shortcut is the interior of the staged input; the
                  // output replaces it element by element
                  char2* io = reinterpret_cast<char2*>(
                      t.xs + ((r / TW + 1) * HW + r % TW + 1) * p.x_ld + c);
                  const char2 xv = *io;
                  const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(v0), al.x), be.x);
                  const float y1 = __fadd_rn(__fmul_rn(__int2float_rn(v1), al.y), be.y);
                  *io = make_char2(to_code(__fadd_rn(y0, __fmul_rn((float)xv.x, sc))),
                                   to_code(__fadd_rn(y1, __fmul_rn((float)xv.y, sc))));
                }
              }
            }
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[i][jn][u][v] = 0;
          }
        }
      }
    }
    __syncthreads();  // the stage is free to refill; epilogue writes are visible
  }
}

// the warps a conv's plan needs: ceil(MT / TM) for each set of TN groups
// (conv() above), MT row tiles of 16 and nch / 32 groups
int warps_needed(int rows, int nch, int jmax) {
  const int mt = (rows + 15) / 16, tm = mt < jmax ? mt : jmax, tn = jmax / tm;
  return (mt + tm - 1) / tm * ((nch / 32 + tn - 1) / tn);
}

// aff: [alpha_a C1][beta_a C1][alpha_b C1][beta_b C1][alpha_c C3][beta_c C3][sc]
template <int TH, int TW, int JMAX>
__global__ void __launch_bounds__(NT, JMAX == 2 ? 2 : 1)
fused_block_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ ka, int ka_ld,
                   const int8_t* __restrict__ kb, const int8_t* __restrict__ kc, int kc_ld,
                   const float* __restrict__ aff, int8_t* __restrict__ out, int H, int W,
                   int C3, int C1, const Plan p) {
  constexpr int HW = TW + 2;
  constexpr int P1 = (TH + 2) * HW;
  extern __shared__ int4 smem[];
  int8_t* base = reinterpret_cast<int8_t*>(smem);
  const int per_image = p.tiles_h * p.tiles_w;
  const int b = blockIdx.x / per_image, ti = blockIdx.x % per_image;
  Tile t;
  t.xs = base + p.x_off;
  t.m1 = base + p.m1_off;
  t.m2 = base + p.m2_off;
  t.ring = base + p.w_off;
  t.ab = reinterpret_cast<float*>(base + p.ab_off);
  t.H = H;
  t.W = W;
  t.C1 = C1;
  t.y0 = (ti / p.tiles_w) * TH;
  t.x0 = (ti % p.tiles_w) * TW;
  const int c3p = (C3 + 31) / 32 * 32;
  const int8_t* ximg = x + (size_t)b * H * W * C3;

  // the tile's input with its halo, zero outside the image and in the K
  // padding (committed with conv 2a's first weight chunk)
  const int xchunks = c3p / 16;
  for (int i = threadIdx.x; i < P1 * xchunks; i += NT) {
    const int r = i / xchunks, c = i - r * xchunks;
    const int yy = t.y0 - 1 + r / HW, xx = t.x0 - 1 + r % HW;
    const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W && c * 16 < C3;
    cp16(t.xs + r * p.x_ld + c * 16, ok ? ximg + ((size_t)yy * W + xx) * C3 + c * 16 : ximg,
         ok);
  }
  const float* aa = aff;
  const float* ab = aff + 2 * C1;
  const float* ac = aff + 4 * C1;
  const float sc = aff[4 * C1 + 2 * C3];
  conv<CONV_A, TH, TW, JMAX>(p, t, ka, ka_ld, p.kca, C1, C3, c3p, p.na, p.kca, p.wa_ld, aa,
                             aa + C1, 0.0f);
  conv<CONV_B, TH, TW, JMAX>(p, t, kb, p.kcb, (size_t)p.kcb * C1, C1, 9 * C1, 9 * C1, p.nb,
                             p.kcb, p.wb_ld, ab, ab + C1, 0.0f);
  conv<CONV_C, TH, TW, JMAX>(p, t, kc, kc_ld, p.kcc, C3, C1, C1, p.nc, p.kcc, p.wc_ld, ac,
                             ac + C3, sc);

  // the output tile, from the interior of the staged input
  const int ochunks = C3 / 16;
  for (int i = threadIdx.x; i < TH * TW * ochunks; i += NT) {
    const int r = i / ochunks, c = i - r * ochunks;
    const int yy = t.y0 + r / TW, xx = t.x0 + r % TW;
    if (yy < H && xx < W)
      *reinterpret_cast<int4*>(out + (((size_t)b * H + yy) * W + xx) * C3 + c * 16) =
          *reinterpret_cast<const int4*>(t.xs + ((r / TW + 1) * HW + r % TW + 1) * p.x_ld +
                                         c * 16);
  }
}

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

struct PrepArgs {
  // in_scale, sw_a, sw_b, sw_c, bias_a, bias_b, bias_c, inv_a, shift_a,
  // inv_b, shift_b, inv_c, shift_c, scale_b, scale_c, out_scale
  const float* v[16];
  const int8_t* kb;
  long long kbs[4];  // strides of the HWIO kb8 [3][3][C1][C1]
  int8_t* kb_out;    // OHWI in K chunks: [9*C1/kch][C1][kch]
  int kch;
  const int8_t* k1[2];  // ka8, kc8 where they must be packed, else null
  long long k1s[2][2];  // (N stride, K stride)
  int8_t* k1_out[2];    // [N][K]
};

// block_affines (ops/fused_block.py) in its expression order, the Kb pack,
// and the [N][K] pack of a 1x1 kernel whose K is not contiguous
__global__ void fused_block_prep_kernel(const PrepArgs a, float* __restrict__ aff, int C3,
                                        int C1) {
  const float qmax = 127.0f, lo = (float)1e-30;
  const float* const* v = a.v;
  const float sxa = __fdiv_rn(v[0][0], qmax);
  const float r_b = __fdiv_rn(qmax, clamp_min(v[13][0], lo));
  const float r_c = __fdiv_rn(qmax, clamp_min(v[14][0], lo));
  const float r_o = __fdiv_rn(qmax, clamp_min(v[15][0], lo));
  const float sxb = __fdiv_rn(v[13][0], qmax), sxc = __fdiv_rn(v[14][0], qmax);
  const long long n_aff = 2 * C1 + 2 * C1 + 2 * C3 + 1;
  const long long n_kb = 9LL * C1 * C1 / 16;  // 16-byte pieces of Kb
  const long long n_k1 = (long long)C1 * C3;
  const long long total =
      n_aff + n_kb + (a.k1[0] != nullptr ? n_k1 : 0) + (a.k1[1] != nullptr ? n_k1 : 0);
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    if (e < n_aff) {
      // conv s = 0, 1, 2: (sx, sw, bias, inv, shift, r) and its channel count
      const int s = e < 2 * C1 ? 0 : e < 4 * C1 ? 1 : 2;
      const int cn = s < 2 ? C1 : C3;
      const long long first = s * 2LL * C1;
      if (e == n_aff - 1) {
        aff[e] = __fmul_rn(sxa, r_o);
        continue;
      }
      const int c = (int)((e - first) % cn);
      const bool is_beta = e - first >= cn;
      const int i = 1 + s;  // sw_s
      const float sw = v[i][c], bias = v[4 + s][c];
      const float inv = v[7 + 2 * s][c], shift = v[8 + 2 * s][c];
      const float sx = s == 0 ? sxa : s == 1 ? sxb : sxc;
      const float r = s == 0 ? r_b : s == 1 ? r_c : r_o;
      aff[e] = is_beta ? __fmul_rn(__fadd_rn(__fmul_rn(bias, inv), shift), r)
                       : __fmul_rn(__fmul_rn(__fmul_rn(sx, sw), inv), r);
    } else if (e < n_aff + n_kb) {
      const long long o = (e - n_aff) * 16;  // [co][dy][dx][ci], 16 ci a thread
      const long long kk = o % (9LL * C1);   // (dy, dx, ci)
      const int ci = (int)(kk % C1), tap = (int)(kk / C1), co = (int)(o / (9LL * C1));
      const int8_t* src = a.kb + (tap / 3) * a.kbs[0] + (tap % 3) * a.kbs[1] + ci * a.kbs[2] +
                          co * a.kbs[3];
      union {
        int4 v;
        int8_t b[16];
      } piece;
#pragma unroll
      for (int q = 0; q < 16; ++q) piece.b[q] = src[q * a.kbs[2]];
      *reinterpret_cast<int4*>(a.kb_out + (kk / a.kch) * C1 * a.kch + (long long)co * a.kch +
                               kk % a.kch) = piece.v;
    } else {
      long long m = e - n_aff - n_kb;
      int w = 0;  // 0: ka [C1][C3], 1: kc [C3][C1]; only those to pack
      if (a.k1[0] == nullptr || m >= n_k1) {
        m -= a.k1[0] == nullptr ? 0 : n_k1;
        w = 1;
      }
      const int kdim = w == 0 ? C3 : C1;
      const long long nn = m / kdim, kk = m % kdim;
      a.k1_out[w][m] = a.k1[w][nn * a.k1s[w][0] + kk * a.k1s[w][1]];
    }
  }
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace

// ptrs: in_scale, sw_a, sw_b, sw_c, bias_a, bias_b, bias_c, inv_a, shift_a,
// inv_b, shift_b, inv_c, shift_c, scale_b, scale_c, out_scale (f32 on the
// device, contiguous: the four scales one value, the others one a channel),
// kb8, kb_out, ka8 or null, ka_out, kc8 or null, kc_out; kstrides: kb8's 4
// strides, then ka8's and kc8's (N stride, K stride). aff: f32
// [4*C1 + 2*C3 + 1]; kch: the K chunk of the block kernel's plan for conv
// 2b, kb_out [ceil(9*C1/kch)][C1][kch].
extern "C" int fused_block_prep(void* const* ptrs, const long long* kstrides, float* aff,
                                int C3, int C1, int kch, void* stream) {
  if (C3 <= 0 || C1 <= 0 || C1 % 16 || kch <= 0 || kch % 16) return (int)cudaErrorInvalidValue;
  PrepArgs a;
  for (int i = 0; i < 16; ++i) {
    a.v[i] = (const float*)ptrs[i];
    if (a.v[i] == nullptr) return (int)cudaErrorInvalidValue;
  }
  a.kb = (const int8_t*)ptrs[16];
  a.kb_out = (int8_t*)ptrs[17];
  a.kch = kch;
  for (int i = 0; i < 4; ++i) a.kbs[i] = kstrides[i];
  for (int w = 0; w < 2; ++w) {
    a.k1[w] = (const int8_t*)ptrs[18 + 2 * w];
    a.k1_out[w] = (int8_t*)ptrs[19 + 2 * w];
    a.k1s[w][0] = kstrides[4 + 2 * w];
    a.k1s[w][1] = kstrides[5 + 2 * w];
    if (a.k1[w] != nullptr && a.k1_out[w] == nullptr) return (int)cudaErrorInvalidValue;
  }
  if (a.kb == nullptr || a.kb_out == nullptr || aff == nullptr || !aligned16(a.kb_out))
    return (int)cudaErrorInvalidValue;
  const long long total = 4LL * C1 + 2LL * C3 + 1 + 9LL * C1 * C1 / 16 +
                          (a.k1[0] != nullptr ? 1LL * C1 * C3 : 0) +
                          (a.k1[1] != nullptr ? 1LL * C1 * C3 : 0);
  const int blocks = (int)((total + 255) / 256 < 1056 ? (total + 255) / 256 : 1056);
  fused_block_prep_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(a, aff, C3, C1);
  return (int)cudaGetLastError();
}

// x, out: [batch, H, W, C3] int8 NHWC contiguous; ka: [C1][C3] rows of
// stride ka_ld, kb: OHWI in K chunks from fused_block_prep, kc: [C3][C1] rows
// of stride kc_ld (int8, K contiguous); aff from fused_block_prep; plan: PLAN_FIELDS ints of
// ops/fused_block.py `tile_plan`. Returns cudaErrorInvalidValue for a plan
// or operand the kernel cannot run.
extern "C" int fused_block_int8(const void* x, const void* ka, int ka_ld, const void* kb,
                                const void* kc, int kc_ld, const float* aff, void* out,
                                int batch, int H, int W, int C3, int C1, const int* plan,
                                void* stream) {
  if (batch <= 0) return 0;
  Plan p;
  static_assert(sizeof(Plan) == PLAN_FIELDS * sizeof(int), "plan layout");
  int* pf = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_FIELDS; ++i) pf[i] = plan[i];
  const int bad = (int)cudaErrorInvalidValue;
  if (H <= 0 || W <= 0 || C3 <= 0 || C1 <= 0 || C3 % 16 || C1 % 32) return bad;
  if (!aligned16(x) || !aligned16(out) || !aligned16(ka) || !aligned16(kb) || !aligned16(kc) ||
      ka_ld % 16 || kc_ld % 16 || ka_ld < C3 || kc_ld < C1)
    return bad;
  if (p.th <= 0 || p.tw <= 0 || (p.th * p.tw) % 16 || p.tiles_w * p.tw < W ||
      (p.tiles_w - 1) * p.tw >= W || p.tiles_h * p.th < H || (p.tiles_h - 1) * p.th >= H)
    return bad;
  const int p1 = (p.th + 2) * (p.tw + 2);
  if (p.na <= 0 || p.nb <= 0 || p.nc <= 0 || p.na % 32 || p.nb % 32 || p.nc % 32 ||
      (p.jmax != 2 && p.jmax != 4) || warps_needed(p1, p.na, p.jmax) > NWARPS ||
      warps_needed(p.th * p.tw, p.nb, p.jmax) > NWARPS ||
      warps_needed(p.th * p.tw, p.nc, p.jmax) > NWARPS)
    return bad;
  const int kchs[3] = {p.kca, p.kcb, p.kcc}, nchs[3] = {p.na, p.nb, p.nc};
  const int wlds[3] = {p.wa_ld, p.wb_ld, p.wc_ld};
  long long wstage = 0;  // bytes of one ring stage
  for (int i = 0; i < 3; ++i) {
    if ((kchs[i] != 32 && kchs[i] != 64 && kchs[i] != 128) || wlds[i] < kchs[i] || wlds[i] % 16)
      return bad;
    wstage = max(wstage, (long long)nchs[i] * wlds[i]);
  }
  if (p.x_ld < (C3 + 31) / 32 * 32 ||
      p.m1_ld < C1 || p.m2_ld < C1 || (p.x_ld | p.m1_ld | p.m2_ld) % 16)
    return bad;
  // the five regions: 16-byte aligned, inside the block's bytes, disjoint
  const long long nmax = max(p.na, max(p.nb, p.nc));
  const long long lo[5] = {p.x_off, p.m1_off, p.m2_off, p.w_off, p.ab_off};
  const long long len[5] = {(long long)p1 * p.x_ld, (long long)p1 * p.m1_ld,
                            (long long)p.th * p.tw * p.m2_ld, 2 * wstage,
                            2 * 2 * nmax * (long long)sizeof(float)};
  for (int i = 0; i < 5; ++i) {
    if (lo[i] < 0 || lo[i] % 16 || lo[i] + len[i] > p.smem) return bad;
    for (int j = 0; j < i; ++j)
      if (lo[i] < lo[j] + len[j] && lo[j] < lo[i] + len[i]) return bad;
  }
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (p.smem > limit) return bad;
  const long long grid = (long long)batch * p.tiles_h * p.tiles_w;
  if (grid > 0x7fffffff) return bad;
  // the tiles of ops/fused_block.py TILES and FALLBACK_TILE
  void (*kernel)(const int8_t*, const int8_t*, int, const int8_t*, const int8_t*, int,
                 const float*, int8_t*, int, int, int, int, const Plan) =
      p.jmax == 2 ? (p.th == 8 && p.tw == 16 ? fused_block_kernel<8, 16, 2>
                     : p.th == 8 && p.tw == 8 ? fused_block_kernel<8, 8, 2>
                     : p.th == 4 && p.tw == 8 ? fused_block_kernel<4, 8, 2>
                     : p.th == 4 && p.tw == 4 ? fused_block_kernel<4, 4, 2>
                                              : nullptr)
                  : (p.th == 8 && p.tw == 16 ? fused_block_kernel<8, 16, 4>
                     : p.th == 8 && p.tw == 8 ? fused_block_kernel<8, 8, 4>
                     : p.th == 4 && p.tw == 8 ? fused_block_kernel<4, 8, 4>
                     : p.th == 4 && p.tw == 4 ? fused_block_kernel<4, 4, 4>
                                              : nullptr);
  if (kernel == nullptr) return bad;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(int)grid, NT, p.smem, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)ka, ka_ld, (const int8_t*)kb, (const int8_t*)kc, kc_ld,
      aff, (int8_t*)out, H, W, C3, C1, p);
  return (int)cudaGetLastError();
}
