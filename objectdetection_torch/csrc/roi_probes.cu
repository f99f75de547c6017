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
// function (x1 = x0 + 1) behind the per-ROI (level, class) dispatch. The top
// class blends the resident [32, 32*C] bf16 patch; a small class (py, px) in
// {(8,8), (16,16), (24,24)} copies its whole int8 [py, px*C] patch from
// feats[img, 8*yq :, x0*C :], casts the codes to f32 (exact) and blends the
// same way. Columns past the copied patch (x >= px) read zero, where the TPU
// kernel reads stale VMEM. A (level, class) pair outside the TPU's combos
// sets error bit 0 (the TPU kernel would issue no DMA), a patch or blend
// column outside its source bit 1; such a ROI writes nothing. What bounds
// it: bytes, the [n, 7, 7*C] bf16 output written once (2.41 GB at n =
// 96000) and the inputs read once (feats, 16.8 MB, once: the patch copies,
// 6.3 GB for dispatch_small, come from L2). Design (`roi_dispatch_kernel`):
// P2's persistent grid of (ROI range, 64-channel slice) blocks with the top
// patch's slice resident in shared memory, and P2's per-(ROI, q) body, the
// split-tap product on bf16 `mma.sync` (`resident_a`, `b_frags`, `mma_out`,
// `store_q`, shared with `roi_inner_kernel`), so bare runs P2's wide2c
// arithmetic; a warp's ROI inputs and meta row are fetched ahead, and its
// class is one warp-uniform branch. A small-class ROI's 64-channel slice is
// copied with cp.async by the four warps that share the ROI (a stream), four
// threads a 64-byte (row, column) cell, in chunks of 8 patch rows (one half
// k-step of the product) into the stream's ring of two 12 KB stages, the
// shared memory left beside the resident slice: the next chunk, of this ROI
// or of the stream's next ROI, is in flight while the current one blends
// into A fragments held in registers, one barrier of the stream's 128
// threads a chunk. So one chunk is in flight a stream for every class: a
// whole (8, 8) ROI, half a (16, 16) one, a third of a (24, 24) one; two
// stages of the widest chunk are what fits (4 streams x 24 KB beside the
// 128.5 KB slice), and the SM's 4 streams overlap one stream's copy latency
// with the others' blends. (16-byte pieces a warp, each a 256-byte stride
// apart, cost a third more time: an L1 wavefront a piece.) The codes become
// f32 on the FP32 pipe (a byte permute into 2^23's mantissa and one exact
// subtraction), not the quarter-rate conversion unit. The product takes
// ceil(py/16) k-steps; A rows and B taps at k >= py are zero, so nothing past
// the patch enters a product.

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
// at y0 of each row (where y0 == y1, the single entry (1 - w) + w), B1 the
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

// one A fragment register: one channel's xb at rows k (columns v0, v1) and
// k + 1 (columns n0, n1), rounded to bf16
__device__ __forceinline__ unsigned xb_pair(float om, float w, float v0, float v1, float n0,
                                            float n1) {
  return pack_bf16(blend(om, w, v0, v1), blend(om, w, n0, n1));
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

// The body P2 and P3 share, per (ROI, q) on a warp's 16 channels.

// Split-tap B fragments of a ROI, [split][k step][register]: k = 16 s + 8 i
// + 2 t (+1), column g = output row g (g = 7 zero). Split 0 holds wy's entry
// at y0, split 1 the entry at y1 where y1 != y0; wy's entry at k is the
// plain version's bf16(where(k == y0, 1 - w, 0) + where(k == y1, w, 0)) for
// k < PYK, the patch's rows, and zero past them, whatever y0 and y1 say.
template <int PYK>
__device__ __forceinline__ void b_frags(float y0f, float y1f, float w, int g, int t,
                                        unsigned (&b)[2][2][2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i) b[0][s][i] = b[1][s][i] = 0u;
  if (g >= POOL) return;
  const int y0 = xla_to_s32(y0f), y1 = xla_to_s32(y1f);
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tap[2][2];  // [split][k, k + 1]
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = 16 * s + 8 * i + 2 * t + j;
        const float wy = bf16r(__fadd_rn(k == y0 ? __fsub_rn(1.0f, w) : 0.0f,
                                         k == y1 ? w : 0.0f));
        tap[0][j] = k < PYK && k == y0 ? wy : 0.0f;
        tap[1][j] = k < PYK && k == y1 && y1 != y0 ? wy : 0.0f;
      }
      b[0][s][i] = pack_bf16(tap[0][0], tap[0][1]);
      b[1][s][i] = pack_bf16(tap[1][0], tap[1][1]);
    }
}

// A fragments [k step][register] of one q from the resident slice: p0, p1
// point at channels 2g, 2g + 1 of the blend's columns at k = 0; rows g
// (channel 2g) and g + 8 (2g + 1) of the fragment
__device__ __forceinline__ void resident_a(const unsigned* p0, const unsigned* p1, float om,
                                           float w, int t, unsigned (&a)[2][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = 16 * s + 8 * i + 2 * t;
      const unsigned v0 = p0[k * P2_ROW], v1 = p1[k * P2_ROW];
      const unsigned n0 = p0[(k + 1) * P2_ROW], n1 = p1[(k + 1) * P2_ROW];
      a[s][2 * i] = xb_pair(om, w, lo_bf16(v0), lo_bf16(v1), lo_bf16(n0), lo_bf16(n1));
      a[s][2 * i + 1] = xb_pair(om, w, hi_bf16(v0), hi_bf16(v1), hi_bf16(n0), hi_bf16(n1));
    }
}

// out = bf16(D0 + D1) over KS k steps: r0 channels (2g, 2g + 1) at output
// row 2t, r1 at row 2t + 1
template <int KS>
__device__ __forceinline__ void mma_out(const unsigned (&a)[2][4], const unsigned (&b)[2][2][2],
                                        unsigned& r0, unsigned& r1) {
  float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < KS; ++s) mma_bf16(d0, a[s], b[0][s][0], b[0][s][1]);
#pragma unroll
  for (int s = 0; s < KS; ++s) mma_bf16(d1, a[s], b[1][s][0], b[1][s][1]);
  // d[0], d[1]: channel 2g at rows 2t, 2t+1; d[2], d[3]: channel 2g+1
  r0 = pack_bf16(__fadd_rn(d0[0], d1[0]), __fadd_rn(d0[2], d1[2]));
  r1 = pack_bf16(__fadd_rn(d0[1], d1[1]), __fadd_rn(d0[3], d1[3]));
}

// oq: the ROI's output at (row 0, q, channel 2g)
__device__ __forceinline__ void store_q(__nv_bfloat16* oq, int t, unsigned r0, unsigned r1) {
  *reinterpret_cast<unsigned*>(oq + (size_t)(2 * t) * POOL * C) = r0;
  if (2 * t + 1 < POOL) *reinterpret_cast<unsigned*>(oq + (size_t)(2 * t + 1) * POOL * C) = r1;
}

// the slice's [PY][P2_ROW] words of the patch, with cp.async; every thread
// of the block waits for it
__device__ __forceinline__ void load_slice(unsigned* s_patch, const __nv_bfloat16* patch,
                                           int slice) {
  for (int e = threadIdx.x; e < PY * PX * (P2_CS / 8); e += P2_THREADS) {
    const int piece = e % (P2_CS / 8), kx = e / (P2_CS / 8), k = kx / PX, x = kx % PX;
    cp_async16(s_patch + k * P2_ROW + x * (P2_CS / 2) + piece * 4,
               patch + (size_t)kx * C + slice * P2_CS + piece * 8);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
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
  load_slice(s_patch, patch, slice);

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
    unsigned b[2][2][2];
    b_frags<PY>(cur.y0, cur.y1, cur.wy, g, t, b);
    cur = nxt;
    __nv_bfloat16* o = out + (size_t)roi * POOL * POOL * C + ch;
#pragma unroll
    for (int q = 0; q < POOL; ++q) {
      const int xa = __shfl_sync(0xFFFFFFFFu, x0, q), xc = __shfl_sync(0xFFFFFFFFu, x1, q);
      const float w = __shfl_sync(0xFFFFFFFFu, wq, q), om = __fsub_rn(1.0f, w);
      unsigned a[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};  // noblend: a zero xb
      if (V != NOBLEND) resident_a(sp + xa * (P2_CS / 2), sp + xc * (P2_CS / 2), om, w, t, a);
      unsigned r0, r1;
      mma_out<2>(a, b, r0, r1);
      store_q(o + q * C, t, r0, r1);
      if (V == PAIR2)  // unit u computes ROI 2u+1 and writes rows 2u and 2u+1
        store_q(o + q * C - (size_t)POOL * POOL * C, t, r0, r1);
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

// P3. meta [n, 8]: img, level, class, yq, x0 (patch column); xint [n, 7]
// (x1 = x0 + 1); feats [B, fh, fw*C] int8; patch_top [32, 32*C] bf16.
struct P3Args {
  const int* meta;
  const int* xint;
  const float* wx;
  const float* geom;
  const __nv_bfloat16* patch_top;
  const int8_t* feats;
  int b, fh, fw, n;
  __nv_bfloat16* out;
  int* err;
};

constexpr int TOP_CLASS = 3;
constexpr int P3_ROWS = 8;                                  // patch rows a copy chunk
constexpr int P3_STAGE = P3_ROWS * 24 * P2_CS;                // 8 rows x 24 columns x 64 channels
constexpr int P3_SMEM = P2_SMEM + P2_STREAMS * 2 * P3_STAGE;  // 229,888 bytes

// the 128 threads of stream s (its four warps, one ROI at a time) wait for
// each other
__device__ __forceinline__ void stream_sync(int s) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + s), "n"(P2_GROUPS * 32) : "memory");
}

__device__ __forceinline__ int class_size(int cls) { return 8 * (cls + 1); }

// roi_dispatch_probe.py `_combos`: the small classes at every level whose
// map holds them (LEVELS 256, 128, 64, 32), at the top level only class 0
__device__ __forceinline__ bool in_combos(int level, int cls) {
  if (level < 0 || level > 3 || cls < 0 || cls > 2) return false;
  if (level == 3) return cls == 0;
  return class_size(cls) <= (256 >> level);
}

// a lane's inputs of one ROI, as P2's (x1 unused: x0 + 1)
__device__ __forceinline__ P2In p3_fetch(const P3Args& a, long long roi, int lane) {
  P2In r{0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  if (lane < POOL) {
    r.x0 = __ldg(a.xint + roi * POOL + lane);
    r.wq = __ldg(a.wx + roi * POOL + lane);
  }
  const int g = lane >> 2;
  if (g < POOL) {
    const float* gr = a.geom + (roi * POOL + g) * 4;
    r.y0 = __ldg(gr);
    r.y1 = __ldg(gr + 1);
    r.wy = __ldg(gr + 2);
  }
  return r;
}

// lane l < 8: word l of ROI roi's meta row (0 past the range)
__device__ __forceinline__ int p3_meta(const P3Args& a, int roi, int end, int lane) {
  return lane < 8 && roi < end ? __ldg(a.meta + (size_t)roi * 8 + lane) : 0;
}

// a ROI's patch rows from its meta row (lane l holds word l): PY for the top
// class, py for a small class whose patch lies inside feats, 0 for a ROI
// that sets error bit 0 (*bit = 1) or 1 (*bit = 2). Warp-uniform.
__device__ __forceinline__ int p3_rows(int m, const P3Args& a, int* bit) {
  const int img = __shfl_sync(0xFFFFFFFFu, m, 0), level = __shfl_sync(0xFFFFFFFFu, m, 1);
  const int cls = __shfl_sync(0xFFFFFFFFu, m, 2), yq = __shfl_sync(0xFFFFFFFFu, m, 3);
  const int x0 = __shfl_sync(0xFFFFFFFFu, m, 4);
  *bit = 0;
  if (cls == TOP_CLASS) return PY;
  if (!in_combos(level, cls)) {
    *bit = 1;
    return 0;
  }
  const int p = class_size(cls);
  if (img < 0 || img >= a.b || yq < 0 || 8LL * yq + p > a.fh || x0 < 0 ||
      (long long)x0 + p > a.fw) {
    *bit = 2;
    return 0;
  }
  return p;
}

// cp.async of chunk c (patch rows 8c .. 8c+7) of a small-class ROI's 64
// channels (src: feats at the slice's channels) into a stage, by the
// stream's 128 threads (st: the thread's index among them), four threads a
// 64-byte (row, column) cell: the 16 channels of group gp of cell (r, x) at
// 16 * (4 * (r * P + x) + (gp ^ (r / 2 % 4))) bytes, so that the four row
// pairs a warp's fragment load reads lie in distinct banks
template <int P>
__device__ __forceinline__ void p3_issue(unsigned char* stage, const int8_t* src, int m, int c,
                                         const P3Args& a, int st) {
  const int img = __shfl_sync(0xFFFFFFFFu, m, 0), yq = __shfl_sync(0xFFFFFFFFu, m, 3);
  const int x0 = __shfl_sync(0xFFFFFFFFu, m, 4);
  const int8_t* base = src + (((size_t)img * a.fh + 8 * yq + P3_ROWS * c) * a.fw + x0) * C;
#pragma unroll
  for (int j = 0; j < P / 4; ++j) {  // 32 P pieces, P / 4 a thread
    const int e = st + 128 * j, gp = e & 3, cell = e >> 2, r = cell / P, x = cell % P;
    cp_async16(stage + (4 * cell + (gp ^ ((r >> 1) & 3))) * 16,
               base + ((size_t)r * a.fw + x) * C + gp * 16);
  }
}

// chunk 0 of a ROI of p rows, in a group of its own
__device__ __forceinline__ void p3_issue_first(int p, unsigned char* stage, const int8_t* src,
                                               int m, const P3Args& a, int st) {
  if (p == 8)
    p3_issue<8>(stage, src, m, 0, a, st);
  else if (p == 16)
    p3_issue<16>(stage, src, m, 0, a, st);
  else
    p3_issue<24>(stage, src, m, 0, a, st);
  cp_async_commit();
}

// channels 2g, 2g + 1 of column x of a staged row (f32 of the int8 codes,
// exact); columns past the patch read zero
template <int P>
__device__ __forceinline__ float2 p3_codes(const unsigned char* row, int x) {
  if (x >= P) return make_float2(0.0f, 0.0f);
  const unsigned v = *reinterpret_cast<const unsigned short*>(row + x * P2_CS);
  // code + 128 as the low byte of 2^23's f32, minus 2^23 + 128: exact, and
  // on the FP32 pipe rather than the quarter-rate conversion unit
  const unsigned u = v ^ 0x8080u;
  return make_float2(__fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)), 8388736.0f),
                     __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)), 8388736.0f));
}

// A fragment halves of a staged chunk for every q on group grp: rows 2t,
// 2t + 1 of the chunk; [q][0] channel 2g (fragment row g), [q][1] channel
// 2g + 1 (g + 8)
template <int P>
__device__ __forceinline__ void p3_chunk_a(const unsigned char* stage, int x0, float wq, int grp,
                                           int g, int t, unsigned (&h)[POOL][2]) {
  const unsigned char* row0 = stage + 2 * t * P * P2_CS + (grp ^ t) * 16 + 2 * g;
  const unsigned char* row1 = row0 + P * P2_CS;
#pragma unroll
  for (int q = 0; q < POOL; ++q) {
    const int xa = __shfl_sync(0xFFFFFFFFu, x0, q);
    const float w = __shfl_sync(0xFFFFFFFFu, wq, q), om = __fsub_rn(1.0f, w);
    const float2 v0 = p3_codes<P>(row0, xa), v1 = p3_codes<P>(row0, xa + 1);
    const float2 n0 = p3_codes<P>(row1, xa), n1 = p3_codes<P>(row1, xa + 1);
    h[q][0] = xb_pair(om, w, v0.x, v1.x, n0.x, n1.x);
    h[q][1] = xb_pair(om, w, v0.y, v1.y, n0.y, n1.y);
  }
}

// where a warp stands: its stream, group, lane's fragment row and column,
// and its thread's index among the stream's 128
struct P3Warp {
  int stream, grp, g, t, st;
};

// A small-class ROI (P rows and columns) on the warp's 16 channels, the
// stream's four warps together. Its chunk 0 is in flight (item `done` of
// the stream's copies, in stage done & 1). Each chunk's step waits for its
// chunk and for the stream's warps (which frees the other stage), issues the
// next item into the other stage (this ROI's next chunk, or, where next_rows
// > 0, the stream's next ROI's first), then blends its own.
template <int P>
__device__ __forceinline__ void p3_small(unsigned char* ring, int& done, const int8_t* src, int m,
                                         int next_rows, int m_next, const P3Args& a,
                                         const P2In& in, int x0, __nv_bfloat16* o,
                                         const P3Warp& w) {
  constexpr int NC = P / P3_ROWS, KS = (P + 15) / 16;
  unsigned h[NC][POOL][2];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    unsigned char* next = ring + ((done + 1) & 1) * P3_STAGE;
    cp_async_wait<0>();
    stream_sync(w.stream);  // this chunk has landed, and the other stage is read
    if (c + 1 < NC) {
      p3_issue<P>(next, src, m, c + 1, a, w.st);
      cp_async_commit();
    } else if (next_rows) {
      p3_issue_first(next_rows, next, src, m_next, a, w.st);
    }
    p3_chunk_a<P>(ring + (done & 1) * P3_STAGE, x0, in.wq, w.grp, w.g, w.t, h[c]);
    ++done;
  }
  unsigned b[2][2][2];
  b_frags<P>(in.y0, in.y1, in.wy, w.g, w.t, b);
#pragma unroll
  for (int q = 0; q < POOL; ++q) {
    unsigned f[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};  // rows k >= P zero
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      f[c >> 1][2 * (c & 1)] = h[c][q][0];
      f[c >> 1][2 * (c & 1) + 1] = h[c][q][1];
    }
    unsigned r0, r1;
    mma_out<KS>(f, b, r0, r1);
    store_q(o + q * C, w.t, r0, r1);
  }
}

// grid (ranges, P2_SLICES); bare: every ROI the top class, meta not read
template <bool BARE>
__global__ void __launch_bounds__(P2_THREADS, 1) roi_dispatch_kernel(P3Args a) {
  extern __shared__ __align__(16) unsigned s_patch[];  // [PY][P2_ROW] words, then the rings
  const int slice = blockIdx.y;
  const int u0 = (int)((long long)a.n * blockIdx.x / gridDim.x);
  const int u1 = (int)((long long)a.n * (blockIdx.x + 1) / gridDim.x);
  if (u0 >= u1) return;
  load_slice(s_patch, a.patch_top, slice);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp % P2_GROUPS;
  const unsigned* sp = s_patch + grp * 8 + g;  // channels 2g, 2g+1 of the group at k = x = 0
  const int ch = slice * P2_CS + grp * 16 + 2 * g;
  const bool reporter = slice == 0 && grp == 0;  // the one warp a ROI that sets error bits
  const P3Warp w{warp / P2_GROUPS, grp, g, t, grp * 32 + lane};
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(s_patch + PY * P2_ROW) + w.stream * 2 * P3_STAGE;
  const int8_t* src = a.feats + slice * P2_CS;
  // a ROI's inputs are fetched one ROI ahead, its meta row two (the next
  // ROI's class decides the copy issued during this one)
  int u = u0 + warp / P2_GROUPS;
  P2In cur{0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  if (u < u1) cur = p3_fetch(a, u, lane);
  int m_cur = 0, m_next = 0, done = 0, bit = 0;
  if (!BARE) {
    m_cur = p3_meta(a, u, u1, lane);
    m_next = p3_meta(a, u + P2_STREAMS, u1, lane);
    const int rows = u < u1 ? p3_rows(m_cur, a, &bit) : 0;
    if (rows && rows < PY) p3_issue_first(rows, ring, src, m_cur, a, w.st);
  }
  for (; u < u1; u += P2_STREAMS) {
    const P2In nxt = u + P2_STREAMS < u1 ? p3_fetch(a, u + P2_STREAMS, lane) : cur;
    int rows = PY, next_rows = 0, m_after = 0;
    if (!BARE) {
      m_after = p3_meta(a, u + 2 * P2_STREAMS, u1, lane);
      rows = p3_rows(m_cur, a, &bit);
      if (bit && reporter && lane == 0) atomicOr(a.err, bit);
      if (u + P2_STREAMS < u1) {
        next_rows = p3_rows(m_next, a, &bit);
        if (next_rows == PY) next_rows = 0;  // only a small class copies
      }
    }
    // lane q < 7: blend q's columns x0, x0 + 1
    int x0 = cur.x0;
    if (lane < POOL && (x0 < 0 || x0 + 1 >= PX)) {
      if (reporter) atomicOr(a.err, 2);
      x0 = 0;
    }
    const P2In in = cur;
    cur = nxt;
    __nv_bfloat16* o = a.out + (size_t)u * POOL * POOL * C + ch;
    if (rows == PY) {
      if (next_rows) p3_issue_first(next_rows, ring + (done & 1) * P3_STAGE, src, m_next, a, w.st);
      unsigned b[2][2][2];
      b_frags<PY>(in.y0, in.y1, in.wy, g, t, b);
#pragma unroll
      for (int q = 0; q < POOL; ++q) {
        const int xa = __shfl_sync(0xFFFFFFFFu, x0, q);
        const float wq = __shfl_sync(0xFFFFFFFFu, in.wq, q), om = __fsub_rn(1.0f, wq);
        unsigned f[2][4];
        resident_a(sp + xa * (P2_CS / 2), sp + (xa + 1) * (P2_CS / 2), om, wq, t, f);
        unsigned r0, r1;
        mma_out<2>(f, b, r0, r1);
        store_q(o + q * C, t, r0, r1);
      }
    } else if (!BARE) {
      if (rows == 8)
        p3_small<8>(ring, done, src, m_cur, next_rows, m_next, a, in, x0, o, w);
      else if (rows == 16)
        p3_small<16>(ring, done, src, m_cur, next_rows, m_next, a, in, x0, o, w);
      else if (rows == 24)
        p3_small<24>(ring, done, src, m_cur, next_rows, m_next, a, in, x0, o, w);
      else if (next_rows)  // a ROI that sets an error bit writes nothing
        p3_issue_first(next_rows, ring + (done & 1) * P3_STAGE, src, m_next, a, w.st);
    }
    m_cur = m_next;
    m_next = m_after;
  }
  cp_async_wait<0>();
}

template <bool BARE>
int launch_dispatch(const P3Args& a, cudaStream_t s) {
  const int smem = BARE ? P2_SMEM : P3_SMEM;
  int sms = 0;
  cudaError_t e = cudaFuncSetAttribute(roi_dispatch_kernel<BARE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  // one block a SM: ranges of ROIs for each slice, each at least a ROI a stream
  const int ranges = max(1, min(sms / P2_SLICES, (a.n + P2_STREAMS - 1) / P2_STREAMS));
  roi_dispatch_kernel<BARE><<<dim3(ranges, P2_SLICES), P2_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
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
  if ((uintptr_t)patch_top % 16 || (uintptr_t)feats % 16) return (int)cudaErrorInvalidValue;
  const P3Args a{meta, xint, wx, geom, (const __nv_bfloat16*)patch_top, feats, b, fh, fw, n,
                 (__nv_bfloat16*)out, err};
  const cudaStream_t s = (cudaStream_t)stream;
  return bare ? launch_dispatch<true>(a, s) : launch_dispatch<false>(a, s);
}
