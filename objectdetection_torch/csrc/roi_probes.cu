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
// then out = bf16(wy @ xb) with wy [7, 32] bf16 built from geom. The patch
// (512 KB) exceeds a block's shared memory, so it is read through L2 (it
// stays resident there). One block per ROI (per pair for pair2); thread c
// owns channel c, and for each q and each patch row k computes xb once and
// adds wy[r, k] * xb into 7 f32 accumulators: the dense product, in k order.
// Exactness: wy has at most two nonzero entries per row, every bf16 product
// is exact in f32, and adding an exact zero changes nothing, so each output
// is one rounding of a two-term sum whatever the order: bit-equal to the
// plain version (which multiplies in f32). What bounds it: bytes (the
// 2.41 GB output at n = 96000); the CUDA-core product costs 2*7*32 f32
// operations per xb value.
//
// P3 `roi_dispatch_probe` replaces benchmarks/roi_dispatch_probe.py `kernel`
// (:61, pallas_call :250), variants bare, dispatch and dispatch_small: P2's
// body (x1 = x0 + 1) behind the per-ROI (level, class) dispatch. The top
// class blends the resident [32, 32*C] bf16 patch; a small class (py, px) in
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

template <int V>
__global__ void __launch_bounds__(THREADS)
roi_inner_kernel(const int* __restrict__ xint, const float* __restrict__ wx,
                 const float* __restrict__ geom, const __nv_bfloat16* __restrict__ patch,
                 __nv_bfloat16* __restrict__ out, int* err) {
  __shared__ RoiTab t;
  // pair2: block m computes ROI 2m+1 and writes it to rows 2m and 2m+1
  const long long roi = V == PAIR2 ? 2LL * blockIdx.x + 1 : blockIdx.x;
  if (threadIdx.x < POOL) {
    const int q = threadIdx.x;
    int x0 = xint[roi * 2 * POOL + q], x1 = xint[roi * 2 * POOL + POOL + q];
    if (V == STATIC_X) {
      x0 = 4 * q;
      x1 = 4 * q + 1;
    } else if (V == WIDE2C) {
      x1 = x0 + 1;
    }
    if (V != NOBLEND && (x0 < 0 || x0 >= PX || x1 < 0 || x1 >= PX)) {
      atomicOr(err, 1);
      x0 = x1 = 0;
    }
    t.x0[q] = x0;
    t.x1[q] = x1;
    t.wq[q] = wx[roi * POOL + q];
  }
  fill_wy(geom + roi * POOL * 4, PY, t);
  __syncthreads();
  const int c = threadIdx.x;  // THREADS == C
  for (int q = 0; q < POOL; ++q) {
    const int col = q * C + c;
    const __nv_bfloat16* p0 = patch + (size_t)t.x0[q] * C + c;
    const __nv_bfloat16* p1 = patch + (size_t)t.x1[q] * C + c;
    const float w = t.wq[q];
    if (V == NOMATMUL) {  // out = xb rows 0..6
      for (int r = 0; r < POOL; ++r) {
        const float xb = xblend(__bfloat162float(p0[(size_t)r * PX * C]),
                                __bfloat162float(p1[(size_t)r * PX * C]), w);
        out[(roi * POOL + r) * POOL * C + col] = __float2bfloat16_rn(xb);
      }
      continue;
    }
    float acc[POOL];
#pragma unroll
    for (int r = 0; r < POOL; ++r) acc[r] = 0.0f;
    for (int k = 0; k < PY; ++k) {
      // noblend: the TPU kernel reads a scratch it never writes; here zero
      const float xb = V == NOBLEND ? 0.0f
                                    : xblend(__bfloat162float(p0[(size_t)k * PX * C]),
                                             __bfloat162float(p1[(size_t)k * PX * C]), w);
#pragma unroll
      for (int r = 0; r < POOL; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(t.wy[r][k], xb));
    }
#pragma unroll
    for (int r = 0; r < POOL; ++r) {
      const __nv_bfloat16 v = __float2bfloat16_rn(acc[r]);
      out[(roi * POOL + r) * POOL * C + col] = v;
      if (V == PAIR2) out[((roi - 1) * POOL + r) * POOL * C + col] = v;
    }
  }
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
  const auto* pt = (const __nv_bfloat16*)patch;
  auto* o = (__nv_bfloat16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case FULL: roi_inner_kernel<FULL><<<n, THREADS, 0, s>>>(xint, wx, geom, pt, o, err); break;
    case STATIC_X:
      roi_inner_kernel<STATIC_X><<<n, THREADS, 0, s>>>(xint, wx, geom, pt, o, err);
      break;
    case WIDE2C: roi_inner_kernel<WIDE2C><<<n, THREADS, 0, s>>>(xint, wx, geom, pt, o, err); break;
    case NOMATMUL:
      roi_inner_kernel<NOMATMUL><<<n, THREADS, 0, s>>>(xint, wx, geom, pt, o, err);
      break;
    case NOBLEND:
      roi_inner_kernel<NOBLEND><<<n, THREADS, 0, s>>>(xint, wx, geom, pt, o, err);
      break;
    case PAIR2:
      if (n % 2) return (int)cudaErrorInvalidValue;
      roi_inner_kernel<PAIR2><<<n / 2, THREADS, 0, s>>>(xint, wx, geom, pt, o, err);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
