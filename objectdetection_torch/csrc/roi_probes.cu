// The three ROIAlign design probes of the TPU round, as Hopper kernels.
//
// P1 `patch_dma_probe` replaces benchmarks/patch_dma_probe.py `make_probe`
// (kernel :31, pallas_call :70): every ROI's whole [p, p, C] bf16 patch of a
// [B, H, W, C] source is copied into shared memory; the output is the f32 sum
// over ROIs of patch[0, 0, :], in ROI order. The copy is the work: a kernel
// that loaded only that row would give the same number and measure nothing.
// What bounds it: bytes, every patch read once from HBM (random patches of a
// 1 GB source miss the 50 MB L2). Design: cp.async (16 B a thread) into a
// ring of two 32 KB stages; a patch is copied in chunks of whole rows (a row
// is p*C contiguous values, p*C*2 bytes), so chunk k+1 is in flight while
// chunk k is consumed, across the ROIs a block walks. Each block walks a
// contiguous range of ROIs and sums in ROI order into per-block partials; a
// second kernel adds the partials in block order. The result is fixed for a
// given grid, within n * 2^-24 * sum|x| of the exact sum per channel.
//
// P2 `roi_inner_probe` replaces benchmarks/roi_inner_probe.py `kernel` (:39,
// pallas_call :158), every variant: per ROI, 7 x-blends of a resident
// [32, 32*C] bf16 patch, xb[k, q*C + c] = bf16((1-w_q)*v0 + w_q*v1) in f32,
// then out = bf16(wy @ xb) with wy [7, 32] bf16 built from geom. What bounds
// it: bytes (the 2.41 GB output at n = 96000, 0.72 ms), but the blend's ~6
// CUDA-core instructions per xb value (two bf16 unpacks, 2 mul, 1 add, half
// a pack and a load: 5.5 G values a call) set a floor above that. Design:
// the patch (512 KB) split into 4 slices of 64 channels, each resident in a
// block's shared memory (the TPU kernel's resident VMEM patch), loaded once
// with cp.async by a persistent grid of (ROI range, slice) blocks, one a SM;
// the y-product on bf16 tensor cores (mma.sync m16n8k16), split by tap so
// that it stays exact (below, at `roi_inner_kernel`).
//
// P3 `roi_dispatch_probe` replaces benchmarks/roi_dispatch_probe.py `kernel`
// (:61, pallas_call :250), variants bare, dispatch and dispatch_small: P2's
// function (x1 = x0 + 1) behind the per-ROI (level, class) dispatch, one
// block a ROI, thread c channel c, the product on CUDA cores (`RoiTab`,
// `fill_wy`, `xblend`). The top class blends the resident [32, 32*C] bf16
// patch read through L2; a small class (py, px) in
// {(8,8), (16,16), (24,24)} copies its int8 [py, px*C] patch from feats[img,
// 8*yq :, x0*C :] into shared memory, casts to bf16 (exact) and blends the
// same way. A (24, 24) patch is 147 KB, so a block stages 4 patch rows at a
// time in one 24 KB buffer and carries the 49 accumulators across the
// chunks. Columns past the copied patch (x >= px) read zero, where the TPU
// kernel reads stale VMEM. A (level, class) pair outside the TPU's combos
// sets the error flag (the TPU kernel would issue no DMA). What bounds it:
// bytes (the output; feats, 16.8 MB, sits in L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_int.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int P1_STAGE = 32768;  // bytes of one pipeline stage
constexpr int C = 256;           // channels of P2 and P3
constexpr int POOL = 7;
constexpr int PY = 32;           // rows of the resident patch
constexpr int PX = 32;           // columns of the resident patch
constexpr int CHUNK_ROWS = 4;    // patch rows P3 stages at a time (every class a multiple)
constexpr int MAX_PX = 24;       // widest small class

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ------------------------------------------------------------------ P1

struct P1Args {
  const __nv_bfloat16* src;
  int b, h, w, c;
  const int* ii;
  const int* yy;
  const int* xq;
  long long n;
  int p, rows_per_chunk, chunks;
  float* partial;
  int* err;
};

__device__ __forceinline__ bool p1_valid(const P1Args& a, long long roi) {
  const int i = a.ii[roi], y = a.yy[roi], x = a.xq[roi];
  return i >= 0 && i < a.b && y >= 0 && y <= a.h - a.p && x >= 0 &&
         (long long)x * 8 <= a.w - a.p;
}

__device__ __forceinline__ void p1_issue(const P1Args& a, long long r0, long long k,
                                         unsigned char* stage) {
  const long long roi = r0 + k / a.chunks;
  const int chunk = (int)(k % a.chunks);
  if (!p1_valid(a, roi)) return;
  const int i = a.ii[roi], y = a.yy[roi], x = a.xq[roi] * 8;
  const int rbeg = chunk * a.rows_per_chunk;
  const int rows = min(a.rows_per_chunk, a.p - rbeg);
  const int row_bytes = a.p * a.c * 2;
  const int pieces = row_bytes / 16;
  for (int t = threadIdx.x; t < rows * pieces; t += THREADS) {
    const int r = t / pieces, piece = t % pieces;
    const unsigned char* g = reinterpret_cast<const unsigned char*>(
        a.src + (((size_t)i * a.h + y + rbeg + r) * a.w + x) * a.c);
    cp_async16(stage + (size_t)r * row_bytes + piece * 16, g + piece * 16);
  }
}

__global__ void __launch_bounds__(THREADS) patch_dma_kernel(P1Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long r0 = a.n * blockIdx.x / gridDim.x;
  const long long r1 = a.n * (blockIdx.x + 1) / gridDim.x;
  const long long items = (r1 - r0) * a.chunks;
  float acc = 0.0f;  // channel threadIdx.x
  if (items > 0) p1_issue(a, r0, 0, smem);
  cp_async_commit();
  for (long long k = 0; k < items; ++k) {
    if (k + 1 < items) p1_issue(a, r0, k + 1, smem + ((k + 1) & 1) * P1_STAGE);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (k % a.chunks == 0) {
      const long long roi = r0 + k / a.chunks;
      if (!p1_valid(a, roi)) {
        if (threadIdx.x == 0) atomicOr(a.err, 1);
      } else if (threadIdx.x < a.c) {
        const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(smem + (k & 1) * P1_STAGE);
        acc = __fadd_rn(acc, __bfloat162float(st[threadIdx.x]));  // patch[0, 0, c]
      }
    }
    __syncthreads();  // the stage is refilled two items later
  }
  cp_async_wait<0>();
  if (threadIdx.x < a.c) a.partial[(size_t)blockIdx.x * a.c + threadIdx.x] = acc;
}

__global__ void partial_sum_kernel(const float* partial, int blocks, int c, float* out) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s = __fadd_rn(s, partial[(size_t)b * c + ch]);
  out[ch] = s;
}

// ------------------------------------------------------------ P2 and P3

enum Variant { FULL = 0, STATIC_X = 1, WIDE2C = 2, NOMATMUL = 3, NOBLEND = 4, PAIR2 = 5 };

// The per-ROI tables every thread reads: x columns and weights of the 7
// blends, wy [7, 32] rounded to bf16.
struct RoiTab {
  int x0[POOL], x1[POOL];
  float wq[POOL];
  float wy[POOL][PY];
};

// wy[r, k] = bf16(where(k == y0, 1 - w, 0) + where(k == y1, w, 0)), f32 sum
__device__ __forceinline__ void fill_wy(const float* geom_roi, int py, RoiTab& t) {
  for (int e = threadIdx.x; e < POOL * py; e += blockDim.x) {
    const int r = e / py, k = e % py;
    const float* g = geom_roi + r * 4;
    const int y0 = xla_to_s32(g[0]), y1 = xla_to_s32(g[1]);
    const float w = g[2];
    const float a = k == y0 ? __fsub_rn(1.0f, w) : 0.0f;
    const float b = k == y1 ? w : 0.0f;
    t.wy[r][k] = bf16r(__fadd_rn(a, b));
  }
}

// The blend of one xb value from its two columns' values, rounded to bf16.
__device__ __forceinline__ float xblend(float v0, float v1, float w) {
  return bf16r(__fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), v0), __fmul_rn(w, v1)));
}

// P2. A block owns one slice of P2_CS channels of the patch, resident in
// shared memory ([k][x][channel] bf16, each k row padded by 16 bytes so that
// a warp's loads of one (x, k + 2t) hit 32 distinct banks), and walks a
// range of work units (ROIs; pairs for pair2). Warp w takes the slice's
// 16-channel group w % P2_GROUPS of every P2_STREAMS-th unit of the range:
// no barrier after the slice's load. Per (ROI, q), the warp computes the
// transposed product D^T[16 channels, 8] = xb^T[16, 32] @ wy^T[32, 8] on
// mma.sync m16n8k16 (bf16 in, f32 accumulation): the A fragments are the
// x-blends, computed in f32 straight into registers (row g of the fragment
// is channel 2g of the group, row g + 8 channel 2g + 1, so one 32-bit load
// gives both channels of a lane), and the B fragments (column n = output row
// r = n, r = 7 zero) are built once a ROI. Split taps: B0 holds wy's entry
// at y0 of each row (where y0 == y1, the single entry fill_wy makes), B1 the
// entry at y1 where y1 != y0; each accumulator then holds one exact
// bf16 x bf16 product plus exact zeros, and bf16(__fadd_rn(D0, D1)) is the
// plain version's single rounding of a two-term sum. nomatmul, which has no
// product, has a kernel of its own (`roi_inner_rows_kernel`).

constexpr int P2_CS = 64;                          // channels of a slice
constexpr int P2_SLICES = C / P2_CS;               // 4
constexpr int P2_GROUPS = P2_CS / 16;              // 16-channel groups a slice
constexpr int P2_WARPS = 16;
constexpr int P2_THREADS = P2_WARPS * 32;
constexpr int P2_STREAMS = P2_WARPS / P2_GROUPS;   // units a block has in flight
constexpr int P2_ROW = PX * P2_CS / 2 + 4;         // a k row in 32-bit words, padded
constexpr int P2_SMEM = PY * P2_ROW * 4;           // 131,584 bytes

// two f32 -> bf16x2 (round to nearest even): lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xFFFF0000u); }

// the blend before its rounding to bf16: (1 - w) * v0 + w * v1 in f32
__device__ __forceinline__ float blend(float om, float w, float v0, float v1) {
  return __fadd_rn(__fmul_rn(om, v0), __fmul_rn(w, v1));
}

// d += a @ b, m16n8k16, bf16 in, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a lane's inputs of one unit: lane q < 7 the columns and weight of blend q;
// lanes of group g < 7 output row g's geometry (y0, y1, w; not for nomatmul)
struct P2In {
  int x0, x1;
  float wq, y0, y1, wy;
};

template <int V>
__device__ __forceinline__ long long p2_roi(int u) {
  return V == PAIR2 ? 2LL * u + 1 : u;  // pair2: unit u computes ROI 2u+1
}

template <int V>
__device__ __forceinline__ P2In p2_fetch(const int* __restrict__ xint,
                                         const float* __restrict__ wx,
                                         const float* __restrict__ geom, long long roi, int lane) {
  P2In r{0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  if (lane < POOL) {
    r.x0 = __ldg(xint + roi * 2 * POOL + lane);
    r.x1 = __ldg(xint + roi * 2 * POOL + POOL + lane);
    r.wq = __ldg(wx + roi * POOL + lane);
  }
  const int g = lane >> 2;
  if (V != NOMATMUL && g < POOL) {  // nomatmul has no product
    const float* gr = geom + (roi * POOL + g) * 4;
    r.y0 = __ldg(gr);
    r.y1 = __ldg(gr + 1);
    r.wy = __ldg(gr + 2);
  }
  return r;
}

// grid (ranges, P2_SLICES); units: n, or n / 2 for pair2
template <int V>
__global__ void __launch_bounds__(P2_THREADS, 1)
roi_inner_kernel(const int* __restrict__ xint, const float* __restrict__ wx,
                 const float* __restrict__ geom, const __nv_bfloat16* __restrict__ patch,
                 __nv_bfloat16* __restrict__ out, int units, int* err) {
  extern __shared__ __align__(16) unsigned s_patch[];  // [PY][P2_ROW] words
  const int slice = blockIdx.y;
  const int u0 = (int)((long long)units * blockIdx.x / gridDim.x);
  const int u1 = (int)((long long)units * (blockIdx.x + 1) / gridDim.x);
  if (u0 >= u1) return;
  for (int e = threadIdx.x; e < PY * PX * (P2_CS / 8); e += P2_THREADS) {
    const int piece = e % (P2_CS / 8), kx = e / (P2_CS / 8), k = kx / PX, x = kx % PX;
    cp_async16(s_patch + k * P2_ROW + x * (P2_CS / 2) + piece * 4,
               patch + (size_t)kx * C + slice * P2_CS + piece * 8);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp % P2_GROUPS;
  const unsigned* sp = s_patch + grp * 8 + g;  // channels 2g, 2g+1 of the group at k = x = 0
  const int ch = slice * P2_CS + grp * 16 + 2 * g;
  // a unit's inputs are fetched one unit ahead, so their latency hides
  // behind the unit before
  int u = u0 + warp / P2_GROUPS;
  P2In cur{0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  if (u < u1) cur = p2_fetch<V>(xint, wx, geom, p2_roi<V>(u), lane);
  for (; u < u1; u += P2_STREAMS) {
    const long long roi = p2_roi<V>(u);
    const P2In nxt =
        u + P2_STREAMS < u1 ? p2_fetch<V>(xint, wx, geom, p2_roi<V>(u + P2_STREAMS), lane) : cur;
    // lane q < 7: the columns and weight of blend q
    int x0 = cur.x0, x1 = cur.x1;
    const float wq = cur.wq;
    if (lane < POOL) {
      if (V == STATIC_X) {
        x0 = 4 * lane;
        x1 = 4 * lane + 1;
      } else if (V == WIDE2C) {
        x1 = x0 + 1;
      }
      if (V != NOBLEND && (x0 < 0 || x0 >= PX || x1 < 0 || x1 >= PX)) {
        if (slice == 0 && grp == 0) atomicOr(err, 1);
        x0 = x1 = 0;
      }
    }
    // B fragments [split][k step][register]: k = 16 s + 8 i + 2 t (+1), column g
    unsigned b[2][2][2] = {{{0u, 0u}, {0u, 0u}}, {{0u, 0u}, {0u, 0u}}};
    if (g < POOL) {
      const int y0 = xla_to_s32(cur.y0), y1 = xla_to_s32(cur.y1);
      const float w = cur.wy;
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float tap[2][2];  // [split][k, k + 1]
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = 16 * s + 8 * i + 2 * t + j;
            // fill_wy's entry at k
            const float wy = bf16r(__fadd_rn(k == y0 ? __fsub_rn(1.0f, w) : 0.0f,
                                             k == y1 ? w : 0.0f));
            tap[0][j] = k == y0 ? wy : 0.0f;
            tap[1][j] = k == y1 && y1 != y0 ? wy : 0.0f;
          }
          b[0][s][i] = pack_bf16(tap[0][0], tap[0][1]);
          b[1][s][i] = pack_bf16(tap[1][0], tap[1][1]);
        }
    }
    cur = nxt;
    __nv_bfloat16* o = out + (size_t)roi * POOL * POOL * C + ch;
#pragma unroll
    for (int q = 0; q < POOL; ++q) {
      const int xa = __shfl_sync(0xFFFFFFFFu, x0, q), xc = __shfl_sync(0xFFFFFFFFu, x1, q);
      const float w = __shfl_sync(0xFFFFFFFFu, wq, q), om = __fsub_rn(1.0f, w);
      const unsigned* p0 = sp + xa * (P2_CS / 2);
      const unsigned* p1 = sp + xc * (P2_CS / 2);
      __nv_bfloat16* oq = o + q * C;
      unsigned a[2][4];  // [k step][register]: rows g (channel 2g), g + 8 (2g + 1)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (V == NOBLEND) {  // the product of a zero xb
            a[s][2 * i] = a[s][2 * i + 1] = 0u;
            continue;
          }
          const int k = 16 * s + 8 * i + 2 * t;
          const unsigned v0 = p0[k * P2_ROW], v1 = p1[k * P2_ROW];
          const unsigned n0 = p0[(k + 1) * P2_ROW], n1 = p1[(k + 1) * P2_ROW];
          a[s][2 * i] = pack_bf16(blend(om, w, lo_bf16(v0), lo_bf16(v1)),
                                  blend(om, w, lo_bf16(n0), lo_bf16(n1)));
          a[s][2 * i + 1] = pack_bf16(blend(om, w, hi_bf16(v0), hi_bf16(v1)),
                                      blend(om, w, hi_bf16(n0), hi_bf16(n1)));
        }
      float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_bf16(d0, a[0], b[0][0][0], b[0][0][1]);
      mma_bf16(d0, a[1], b[0][1][0], b[0][1][1]);
      mma_bf16(d1, a[0], b[1][0][0], b[1][0][1]);
      mma_bf16(d1, a[1], b[1][1][0], b[1][1][1]);
      // d[0], d[1]: channel 2g at rows 2t, 2t+1; d[2], d[3]: channel 2g+1
      const unsigned r0 = pack_bf16(__fadd_rn(d0[0], d1[0]), __fadd_rn(d0[2], d1[2]));
      const unsigned r1 = pack_bf16(__fadd_rn(d0[1], d1[1]), __fadd_rn(d0[3], d1[3]));
      *reinterpret_cast<unsigned*>(oq + (size_t)(2 * t) * POOL * C) = r0;
      if (2 * t + 1 < POOL) *reinterpret_cast<unsigned*>(oq + (size_t)(2 * t + 1) * POOL * C) = r1;
      if (V == PAIR2) {  // unit u computes ROI 2u+1 and writes rows 2u and 2u+1
        __nv_bfloat16* op = oq - (size_t)POOL * POOL * C;
        *reinterpret_cast<unsigned*>(op + (size_t)(2 * t) * POOL * C) = r0;
        if (2 * t + 1 < POOL)
          *reinterpret_cast<unsigned*>(op + (size_t)(2 * t + 1) * POOL * C) = r1;
      }
    }
  }
}

// nomatmul: out rows 0..6 = xb rows 0..6, no product, so only patch rows
// 0..6 are read: every channel of them (112 KB) stays in one block's shared
// memory, and a warp writes a whole ROI, 512 contiguous bytes a (row, q),
// lane l channels 8l .. 8l+7, with streaming stores (the output is written
// once). grid: blocks, one a SM.
constexpr int P2_ROWS_SMEM = POOL * PX * C * 2;  // 114,688 bytes

__global__ void __launch_bounds__(P2_THREADS, 1)
roi_inner_rows_kernel(const int* __restrict__ xint, const float* __restrict__ wx,
                      const __nv_bfloat16* __restrict__ patch, __nv_bfloat16* __restrict__ out,
                      int n, int* err) {
  extern __shared__ __align__(16) uint4 s_rows[];  // [POOL][PX][C] bf16, 8 channels an entry
  if ((int)blockIdx.x * P2_WARPS >= n) return;
  for (int e = threadIdx.x; e < P2_ROWS_SMEM / 16; e += P2_THREADS)
    cp_async16(s_rows + e, reinterpret_cast<const uint4*>(patch) + e);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int step = (int)gridDim.x * P2_WARPS;  // blocks take consecutive ROIs in turns
  int u = blockIdx.x * P2_WARPS + warp;
  P2In cur{0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  if (u < n) cur = p2_fetch<NOMATMUL>(xint, wx, nullptr, u, lane);
  for (; u < n; u += step) {
    const long long roi = u;
    const P2In nxt = u + step < n ? p2_fetch<NOMATMUL>(xint, wx, nullptr, u + step, lane) : cur;
    int x0 = cur.x0, x1 = cur.x1;
    if (lane < POOL && (x0 < 0 || x0 >= PX || x1 < 0 || x1 >= PX)) {
      atomicOr(err, 1);
      x0 = x1 = 0;
    }
    const float wq = cur.wq;
    cur = nxt;
    uint4* o = reinterpret_cast<uint4*>(out + (size_t)roi * POOL * POOL * C) + lane;
    int xa[POOL], xc[POOL];
    float w[POOL], om[POOL];
#pragma unroll
    for (int q = 0; q < POOL; ++q) {
      xa[q] = __shfl_sync(0xFFFFFFFFu, x0, q);
      xc[q] = __shfl_sync(0xFFFFFFFFu, x1, q);
      w[q] = __shfl_sync(0xFFFFFFFFu, wq, q);
      om[q] = __fsub_rn(1.0f, w[q]);
    }
    // row by row: the warp writes the ROI's 25 KB in address order
#pragma unroll 1
    for (int k = 0; k < POOL; ++k) {
#pragma unroll
      for (int q = 0; q < POOL; ++q) {
        const uint4 v0 = s_rows[(k * PX + xa[q]) * (C / 8) + lane];
        const uint4 v1 = s_rows[(k * PX + xc[q]) * (C / 8) + lane];
        uint4 r;
        r.x = pack_bf16(blend(om[q], w[q], lo_bf16(v0.x), lo_bf16(v1.x)),
                        blend(om[q], w[q], hi_bf16(v0.x), hi_bf16(v1.x)));
        r.y = pack_bf16(blend(om[q], w[q], lo_bf16(v0.y), lo_bf16(v1.y)),
                        blend(om[q], w[q], hi_bf16(v0.y), hi_bf16(v1.y)));
        r.z = pack_bf16(blend(om[q], w[q], lo_bf16(v0.z), lo_bf16(v1.z)),
                        blend(om[q], w[q], hi_bf16(v0.z), hi_bf16(v1.z)));
        r.w = pack_bf16(blend(om[q], w[q], lo_bf16(v0.w), lo_bf16(v1.w)),
                        blend(om[q], w[q], hi_bf16(v0.w), hi_bf16(v1.w)));
        __stcs(o + (k * POOL * C + q * C) / 8, r);  // written once: evict first
      }
    }
  }
}

// the number of SMs of the current device, for the persistent grids
cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess ? e : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int V>
int launch_inner(const int* xint, const float* wx, const float* geom, const __nv_bfloat16* patch,
                 __nv_bfloat16* out, int units, int* err, cudaStream_t s) {
  int sms = 0;
  cudaError_t e = cudaFuncSetAttribute(roi_inner_kernel<V>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, P2_SMEM);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  // one block a SM: ranges of units for each slice, each at least a unit a stream
  const int ranges = max(1, min(sms / P2_SLICES, (units + P2_STREAMS - 1) / P2_STREAMS));
  roi_inner_kernel<V><<<dim3(ranges, P2_SLICES), P2_THREADS, P2_SMEM, s>>>(
      xint, wx, geom, patch, out, units, err);
  return (int)cudaGetLastError();
}

int launch_rows(const int* xint, const float* wx, const __nv_bfloat16* patch,
                __nv_bfloat16* out, int n, int* err, cudaStream_t s) {
  int sms = 0;
  cudaError_t e = cudaFuncSetAttribute(roi_inner_rows_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, P2_ROWS_SMEM);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int blocks = max(1, min(sms, (n + P2_WARPS - 1) / P2_WARPS));
  roi_inner_rows_kernel<<<blocks, P2_THREADS, P2_ROWS_SMEM, s>>>(xint, wx, patch, out, n, err);
  return (int)cudaGetLastError();
}

// P3. meta [n, 8]: img, level, class, yq, x0 (patch column); feats [B, fh,
// fw*C] int8; patch_top [32, 32*C] bf16.
struct P3Args {
  const int* meta;
  const int* xint;
  const float* wx;
  const float* geom;
  const __nv_bfloat16* patch_top;
  const int8_t* feats;
  int b, fh, fw;
  __nv_bfloat16* out;
  int* err;
};

constexpr int TOP_CLASS = 3;

__device__ __forceinline__ int class_size(int cls) { return 8 * (cls + 1); }

// roi_dispatch_probe.py `_combos`: the small classes at every level whose
// map holds them (LEVELS 256, 128, 64, 32), at the top level only class 0
__device__ __forceinline__ bool in_combos(int level, int cls) {
  if (level < 0 || level > 3 || cls < 0 || cls > 2) return false;
  if (level == 3) return cls == 0;
  return class_size(cls) <= (256 >> level);
}

template <bool BARE>
__global__ void __launch_bounds__(THREADS) roi_dispatch_kernel(P3Args a) {
  __shared__ RoiTab t;
  __shared__ __align__(16) int8_t buf[CHUNK_ROWS * MAX_PX * C];  // 24 KB
  __shared__ int s_cls, s_ok;
  const long long roi = blockIdx.x;
  const int* m = a.meta + roi * 8;
  if (threadIdx.x == 0) {
    int cls = TOP_CLASS, ok = 1;
    if (!BARE) {
      cls = m[2];
      if (cls != TOP_CLASS) {
        const int py = class_size(cls), px = py;
        if (!in_combos(m[1], cls)) {
          atomicOr(a.err, 1);
          ok = 0;
        } else if (m[0] < 0 || m[0] >= a.b || m[3] < 0 || 8 * m[3] + py > a.fh || m[4] < 0 ||
                   m[4] + px > a.fw) {
          atomicOr(a.err, 2);
          ok = 0;
        }
      }
    }
    s_cls = cls;
    s_ok = ok;
  }
  if (threadIdx.x < POOL) {
    const int q = threadIdx.x;
    int x0 = a.xint[roi * POOL + q];
    if (x0 < 0 || x0 + 1 >= PX) {
      atomicOr(a.err, 2);
      x0 = 0;
    }
    t.x0[q] = x0;
    t.x1[q] = x0 + 1;
    t.wq[q] = a.wx[roi * POOL + q];
  }
  __syncthreads();
  const int cls = s_cls;
  const bool top = cls == TOP_CLASS;
  const int py = top ? PY : class_size(cls), px = top ? PX : class_size(cls);
  fill_wy(a.geom + roi * POOL * 4, py, t);
  __syncthreads();
  if (!s_ok) return;

  const int c = threadIdx.x;
  float acc[POOL][POOL];  // [q][r]
#pragma unroll
  for (int q = 0; q < POOL; ++q)
#pragma unroll
    for (int r = 0; r < POOL; ++r) acc[q][r] = 0.0f;

  for (int k0 = 0; k0 < py; k0 += CHUNK_ROWS) {
    if (!top) {  // copy patch rows k0 .. k0+3 (px*C bytes each) into buf
      const int row_bytes = px * C, pieces = row_bytes / 16;
      const int8_t* g = a.feats + ((size_t)m[0] * a.fh + 8 * m[3] + k0) * ((size_t)a.fw * C) +
                        (size_t)m[4] * C;
      for (int e = threadIdx.x; e < CHUNK_ROWS * pieces; e += THREADS) {
        const int r = e / pieces, piece = e % pieces;
        cp_async16(buf + r * row_bytes + piece * 16, g + (size_t)r * a.fw * C + piece * 16);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < POOL; ++q) {
      const int x0 = t.x0[q], x1 = t.x1[q];
      const float w = t.wq[q];
      for (int kk = 0; kk < CHUNK_ROWS; ++kk) {
        const int k = k0 + kk;
        float v0, v1;
        if (top) {
          v0 = __bfloat162float(a.patch_top[((size_t)k * PX + x0) * C + c]);
          v1 = __bfloat162float(a.patch_top[((size_t)k * PX + x1) * C + c]);
        } else {  // columns past the copied patch read zero
          v0 = x0 < px ? (float)buf[(kk * px + x0) * C + c] : 0.0f;
          v1 = x1 < px ? (float)buf[(kk * px + x1) * C + c] : 0.0f;
        }
        const float xb = xblend(v0, v1, w);
#pragma unroll
        for (int r = 0; r < POOL; ++r)
          acc[q][r] = __fadd_rn(acc[q][r], __fmul_rn(t.wy[r][k], xb));
      }
    }
    if (!top) __syncthreads();  // before buf is refilled
  }
#pragma unroll
  for (int q = 0; q < POOL; ++q)
#pragma unroll
    for (int r = 0; r < POOL; ++r)
      a.out[(roi * POOL + r) * POOL * C + q * C + c] = __float2bfloat16_rn(acc[q][r]);
}

}  // namespace

// P1. src [b, h, w, c] bf16 (c % 8 == 0, c <= 256, p*c*2 <= 32 KB); i, y, xq
// [n] int32 (patch origin: image, row, column / 8); partial [blocks, c] f32
// scratch; out [c] f32; err: one int32 the caller zeroed (set on an index out
// of range).
extern "C" int patch_dma_probe(const void* src, int b, int h, int w, int c, const int* i,
                               const int* y, const int* xq, long long n, int p, int blocks,
                               float* partial, float* out, int* err, void* stream) {
  if (n <= 0 || blocks <= 0 || p <= 0 || c <= 0 || c > THREADS || c % 8 != 0 ||
      p * c * 2 > P1_STAGE)
    return (int)cudaErrorInvalidValue;
  P1Args a{(const __nv_bfloat16*)src, b, h, w, c, i, y, xq, n, p, 0, 0, partial, err};
  a.rows_per_chunk = min(p, P1_STAGE / (p * c * 2));
  a.chunks = (p + a.rows_per_chunk - 1) / a.rows_per_chunk;
  cudaError_t e = cudaFuncSetAttribute(patch_dma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * P1_STAGE);
  if (e != cudaSuccess) return (int)e;
  patch_dma_kernel<<<blocks, THREADS, 2 * P1_STAGE, (cudaStream_t)stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  partial_sum_kernel<<<(c + 127) / 128, 128, 0, (cudaStream_t)stream>>>(partial, blocks, c, out);
  return (int)cudaGetLastError();
}

// P2. xint [n, 14] int32, wx [n, 7] f32, geom [n, 7, 4] f32, patch [32, 32*256]
// bf16, out [n, 7, 7*256] bf16; variant: 0 full, 1 static_x, 2 wide2c,
// 3 nomatmul, 4 noblend, 5 pair2 (n even); err as for P1.
extern "C" int roi_inner_probe(const int* xint, const float* wx, const float* geom,
                               const void* patch, void* out, int n, int variant, int* err,
                               void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)patch % 16) return (int)cudaErrorInvalidValue;  // cp.async pieces
  const auto* pt = (const __nv_bfloat16*)patch;
  auto* o = (__nv_bfloat16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case FULL: return launch_inner<FULL>(xint, wx, geom, pt, o, n, err, s);
    case STATIC_X: return launch_inner<STATIC_X>(xint, wx, geom, pt, o, n, err, s);
    case WIDE2C: return launch_inner<WIDE2C>(xint, wx, geom, pt, o, n, err, s);
    case NOMATMUL: return launch_rows(xint, wx, pt, o, n, err, s);
    case NOBLEND: return launch_inner<NOBLEND>(xint, wx, geom, pt, o, n, err, s);
    case PAIR2:
      if (n % 2) return (int)cudaErrorInvalidValue;
      return launch_inner<PAIR2>(xint, wx, geom, pt, o, n / 2, err, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// P3. meta [n, 8] int32, xint [n, 7] int32, wx [n, 7] f32, geom [n, 7, 4] f32,
// patch_top [32, 32*256] bf16, feats [b, fh, fw*256] int8, out [n, 7, 7*256]
// bf16; bare: 1 for `bare` (every ROI the top class), 0 for the dispatch
// variants; err: bit 0 a (level, class) pair outside the combos, bit 1 an
// index out of range.
extern "C" int roi_dispatch_probe(const int* meta, const int* xint, const float* wx,
                                  const float* geom, const void* patch_top, const int8_t* feats,
                                  int b, int fh, int fw, void* out, int n, int bare, int* err,
                                  void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  P3Args a{meta, xint, wx, geom, (const __nv_bfloat16*)patch_top, feats, b, fh, fw,
           (__nv_bfloat16*)out, err};
  if (bare)
    roi_dispatch_kernel<true><<<n, THREADS, 0, (cudaStream_t)stream>>>(a);
  else
    roi_dispatch_kernel<false><<<n, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
