// Multilevel ROIAlign (crop_and_resize bilinear sampling) over an FPN pyramid.
//
// Replaces the Pallas TPU kernel objectdetection_tpu/ops/roi_align_pallas.py
// `_kernel` (entered through `batched_multilevel_roi_align_pallas`). The
// target is the exact XLA semantics of
// objectdetection_tpu/ops/roi_align.py `batched_multilevel_roi_align`:
//   - each box picks a level of P2..P5 by the FPN rule (`roi_levels`):
//     4 + round(log2(sqrt(max(h*w, 1e-12)) / (224 / sqrt(image area)))),
//     zero-area boxes go to P2, clipped to [2, 5]; with fewer levels given
//     (trailing h = w = 0: one map alone, the cascade's semantic feature),
//     clipped to the last given, as `roi_levels(max_level=1 + levels)`;
//   - a pool x pool grid of samples at y1*(H-1) + i*((y2-y1)*(H-1)/(P-1));
//   - bilinear weights from floor(); corners summed in the order
//     (y0,x0), (y0,x1), (y1,x0), (y1,x1), each weight a float product cast to
//     the feature type, as `wprod` does.
// All-zero boxes need no special case: they land on P2 at sample (0, 0).
// The TPU kernel's `no_fit` reroute (an approximation of its DMA scheme) is
// not reproduced.
//
// Samples outside the map read what the XLA gather reads. JAX indexes one
// virtual table, the levels concatenated and the images inside each level
// (row0 = level_base + image * H * W, then + y * W + x, in int32 that
// wraps); floor(coord) converts as XLA converts (NaN -> 0, saturated to
// int32); i0 is clipped to [0, size-1] but i1 = min(i0 + 1, size-1) is not
// clipped below, so a sample more than a pixel above or left of the map has
// a negative i1. `jnp.take` wraps a negative table index once by the
// table's length (a row of the previous image or level, or for image 0 at P2
// the end of the table) and reads NaN for what is still outside (the
// gradient drops it). A block whose corners all lie in its own map (every
// i1 >= 0, the main paths' case: their boxes are clipped to [0, 1]) takes
// the direct addressing; any other block resolves each corner's table index
// to (level, row) from the level sizes.
//
// The forward (`roi_align_kernel`), one template for every variant, as the
// Pallas kernel takes its epilogues: the float path (f32 or bf16 levels and
// output) and the int8 epilogues of the serving path (`out_quant`,
// `in_scale`): each value times an f32 [ph, pw, C] map and, for int8 output,
// rint + clip to [-128, 127] (quantize_act). What bounds it on the H100:
// bytes (each output written once, the touched corner rows read). Design:
// block (ROI, group of samples); the ROI's level and per-row / per-column
// tables computed once into shared memory; each thread owns one 16-byte
// channel vector (8 bf16, 4 f32 or 16 int8; 1 channel where C is not a
// multiple), so a warp's corner loads, output stores and map loads are
// 16-byte accesses, and THREADS / (C / vector) samples are in flight; the
// grid splits a ROI's samples over blocks (ph * pw from the launch), so a
// 14x14 stage of 200 ROIs fills the card. No division in the sample loop.
//
// Exactness: level, grid and weights are computed in f32 with explicitly
// rounded operations (and --fmad=false), so a sample coordinate cannot move
// across an integer and change floor(). Float path: in f32 the corner sum
// follows the plain version's order exactly (bit-equal); in bf16 the
// products and the sum are taken in f32 and rounded once at the end (the
// plain version rounds to bf16 after every op). The int8 epilogues repeat
// the plain version's blend: f32 levels and int8 codes in exact f32 ops with
// f32 weights (the s_in/127 dequant is in the map), bf16 levels rounded to
// bf16 after every product and sum as the plain version rounds, so the codes
// equal quantize_act of the plain pooled tensor: bit-equal.
//
// The backward (`roi_align_backward_*`) is the gradient with respect to
// P2..P5; the boxes get none, as `jax.lax.stop_gradient(boxes)` gives in
// objectdetection_tpu/ops/roi_align.py. The JAX package has no Pallas kernel
// for it: its gradient is XLA's autodiff of the four-gather sum. Each sample
// adds w * grad_out to its four corners, with the same weights (rounded to
// the feature type, as the forward does). What bounds it: bytes, reading
// grad_out once and writing the dense gradient pyramid once; the f32 sums
// go through L2's atomic units. Design (bf16): `roi_align_mark_kernel`
// marks the table rows the ROIs' corners reach, `roi_align_zero_kernel`
// zeroes only those rows of an f32 scratch, `roi_align_backward_kernel`
// adds into them, and `roi_align_finalize_kernel` writes the dense bf16
// gradient (the rounded sums on marked rows, zeros elsewhere), where a
// zeroed f32 pyramid and a cast pass would move 178 + 178 + 89 MB at
// 1024^2. In f32 the scratch is the result, zeroed whole. The add kernel
// runs one block per (ROI, 32 channels), lane = channel, each warp loading
// the grad_out of PREFETCH samples at once; the corner weights and offsets
// of every sample are computed once into shared memory. A dense ROI (zero,
// tiny and small boxes: footprint of at most two pixels per sample) sums in
// a shared f32 tile over its footprint and adds the tile once per touched
// (pixel, 4 channels), so a pile of zero boxes costs a few adds per ROI;
// any other ROI adds each contribution directly (coalesced f32 atomics).
// The atomics sum in an order that changes from run to run: the result is
// within a few ulps of the plain backward, not bit-equal. A zero
// contribution is skipped; a corner outside the table gets nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "xla_int.cuh"

namespace {

constexpr int MAX_POOL = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// the gradient: channels per block (one per lane), and the footprint pixels
// a block may sum in shared memory (64 KB of f32)
constexpr int SLICE = 32;
constexpr int SHARED_PIXELS = 512;
// returned where no thread layout of the forward fits the channels
constexpr int NO_LAYOUT = -1;

struct Levels {
  int h[4];
  int w[4];
  long long base[5];  // first table row of each level (batch * h * w rows each); base[4]: length
  int count;          // levels given (1..4); the ones after have h = w = 0 and no rows
};

struct Pyramid {
  const void* feat[4];
  Levels dims;
};

struct SumPyramid {
  float* grad[4];
  Levels dims;
};

template <typename T>
struct OutPyramid {
  T* grad[4];
};

struct RoiTables {
  int y0[MAX_POOL], y1[MAX_POOL], x0[MAX_POOL], x1[MAX_POOL];
  int ty0[MAX_POOL], ty1[MAX_POOL];  // JAX's int32 table index of row y: row0 + y * W
  float wy[MAX_POOL], wx[MAX_POOL];
  int level;
};

// int64 -> int32 that wraps, as XLA's int32 arithmetic does
__device__ __forceinline__ int wrap32(long long v) { return (int)(unsigned)v; }

// The row of table index `t` (int32, as JAX computes it) in its level's
// tensor, as `jnp.take` reads it: a negative index wraps once by the table's
// length; nullptr where it is still outside the table (JAX reads NaN there).
// Past the end cannot happen from clipped indices (y, x <= size-1), only
// through int32 wrap-around of a saturated coordinate.
template <typename P>
__device__ __forceinline__ P* table_row(P* const* levels, const Levels& d, int t, int channels) {
  long long i = t;
  if (i < 0) i += d.base[4];
  if (i < 0 || i >= d.base[4]) return nullptr;
  // constant indices only, so that the level pointers stay in registers
  if (i >= d.base[3]) return levels[3] + (size_t)(i - d.base[3]) * channels;
  if (i >= d.base[2]) return levels[2] + (size_t)(i - d.base[2]) * channels;
  if (i >= d.base[1]) return levels[1] + (size_t)(i - d.base[1]) * channels;
  return levels[0] + (size_t)i * channels;
}

__device__ __forceinline__ float to_feat(float v, const float*) { return v; }
__device__ __forceinline__ float to_feat(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// sample axis: positions lo*(S-1) + i*((hi-lo)*(S-1)/(P-1)), i in [0, P)
__device__ __forceinline__ void axis_sample(float lo, float hi, int size, int pool, int i,
                                            int* i0_out, int* i1_out, float* w_out) {
  const float sm1 = (float)(size - 1);
  float coord;
  if (pool > 1) {
    const float step = __fdiv_rn(__fmul_rn(__fsub_rn(hi, lo), sm1), (float)(pool - 1));
    coord = __fadd_rn(__fmul_rn(lo, sm1), __fmul_rn((float)i, step));
  } else {
    coord = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(lo, hi)), sm1);
  }
  const float f = floorf(coord);
  const float w1 = __fsub_rn(coord, f);
  int i0 = xla_to_s32(f);
  const int i1 = min(wrap_add(i0, 1), size - 1);  // not clipped below, as in JAX
  i0 = min(max(i0, 0), size - 1);
  *i0_out = i0;
  *i1_out = i1;
  *w_out = w1;
}

// The ROI's pyramid level and its per-row / per-column sample tables, into
// shared memory; every thread of the block calls it. Returns whether every
// corner lies in the ROI's own map (direct addressing), to every thread.
__device__ __forceinline__ bool roi_tables(const Levels& dims, float4 b, int img, int ph,
                                           int pw, float canonical_scale, float ln2,
                                           RoiTables& s) {
  const float bh = __fsub_rn(b.z, b.x);
  const float bw = __fsub_rn(b.w, b.y);
  if (threadIdx.x == 0) {
    const float area = __fmul_rn(bh, bw);
    int lvl = 2;
    if (area > 0.0f) {
      const float scale = __fdiv_rn(__fsqrt_rn(fmaxf(area, 1e-12f)), canonical_scale);
      const float l2 = __fdiv_rn(logf(scale), ln2);
      lvl = wrap_add(4, xla_to_s32(rintf(l2)));
    }
    s.level = min(max(lvl, 2), dims.count + 1) - 2;
  }
  __syncthreads();
  const int li = s.level;
  const int H = dims.h[li], W = dims.w[li];
  const int t = threadIdx.x;
  bool own = true;
  if (t < ph) {
    axis_sample(b.x, b.z, H, ph, t, &s.y0[t], &s.y1[t], &s.wy[t]);
    const int row0 = wrap32(dims.base[li] + (long long)img * H * W);
    s.ty0[t] = wrap_add(row0, (int)((unsigned)s.y0[t] * (unsigned)W));
    s.ty1[t] = wrap_add(row0, (int)((unsigned)s.y1[t] * (unsigned)W));
    own = s.y1[t] >= 0;
  }
  if (t >= MAX_POOL && t - MAX_POOL < pw) {
    const int j = t - MAX_POOL;
    axis_sample(b.y, b.w, W, pw, j, &s.x0[j], &s.x1[j], &s.wx[j]);
    own = s.x1[j] >= 0;
  }
  return __syncthreads_and(own);
}

// The four corner rows of sample (py, px): direct in the ROI's own map
// (INSIDE), or each resolved in the table (nullptr: outside it, reads NaN).
// A kernel picks INSIDE once per block, so the element loop of the main
// paths' blocks is the direct addressing alone.
template <bool INSIDE, typename P>
__device__ __forceinline__ void corner_rows(P* const* levels, const Levels& d,
                                            const RoiTables& s, P* own_map, int W, int py,
                                            int px, int channels, P* rows[4]) {
  if (INSIDE) {
    const size_t r0 = (size_t)s.y0[py] * W, r1 = (size_t)s.y1[py] * W;
    const size_t c0 = (size_t)s.x0[px], c1 = (size_t)s.x1[px];
    rows[0] = own_map + (r0 + c0) * channels;
    rows[1] = own_map + (r0 + c1) * channels;
    rows[2] = own_map + (r1 + c0) * channels;
    rows[3] = own_map + (r1 + c1) * channels;
  } else {
    rows[0] = table_row(levels, d, wrap_add(s.ty0[py], s.x0[px]), channels);
    rows[1] = table_row(levels, d, wrap_add(s.ty0[py], s.x1[px]), channels);
    rows[2] = table_row(levels, d, wrap_add(s.ty1[py], s.x0[px]), channels);
    rows[3] = table_row(levels, d, wrap_add(s.ty1[py], s.x1[px]), channels);
  }
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The plain version's blend of one value from its four corners: f32 and
// int8 codes (exact f32 ops, f32 weights), or bf16 (each weight, product and
// partial sum rounded to bf16).
template <typename Tin>
__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11, float w00,
                                       float w01, float w10, float w11) {
  float acc = __fmul_rn(v00, w00);
  acc = __fadd_rn(acc, __fmul_rn(v01, w01));
  acc = __fadd_rn(acc, __fmul_rn(v10, w10));
  return __fadd_rn(acc, __fmul_rn(v11, w11));
}
template <>
__device__ __forceinline__ float blend<__nv_bfloat16>(float v00, float v01, float v10, float v11,
                                                      float w00, float w01, float w10,
                                                      float w11) {
  const float p00 = bf16r(__fmul_rn(v00, bf16r(w00)));
  const float p01 = bf16r(__fmul_rn(v01, bf16r(w01)));
  const float p10 = bf16r(__fmul_rn(v10, bf16r(w10)));
  const float p11 = bf16r(__fmul_rn(v11, bf16r(w11)));
  return bf16r(__fadd_rn(bf16r(__fadd_rn(bf16r(__fadd_rn(p00, p01)), p10)), p11));
}

// The int8 epilogue's code: NaN (a NaN box, or a corner outside the table)
// converts to 0, as XLA's convert does
__device__ __forceinline__ int quantize(float v) {
  return isnan(v) ? 0 : (int)fminf(fmaxf(rintf(v), -128.0f), 127.0f);
}

// Channel vectors: N consecutive channels of one row, loaded and stored as
// 16-byte (or narrower) accesses where N fills them, one by one where N = 1.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 q = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = p[k];
  }
}
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[k];
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // a bf16 is the top half of its f32
        v[8 * k + 2 * j] = __uint_as_float(w[j] << 16);
        v[8 * k + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  } else if constexpr (N == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = __bfloat162float(p[k]);
  }
}
template <int N>
__device__ __forceinline__ void load_vec(const int8_t* p, float (&v)[N]) {
  if constexpr (N % 16 == 0) {
#pragma unroll
    for (int k = 0; k < N / 16; ++k) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[k];
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)  // byte j, sign-extended
        v[16 * k + j] = (float)((int)(w[j / 4] << (24 - 8 * (j % 4))) >> 24);
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = (float)p[k];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = v[k];
  }
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&b);
}
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k)
      reinterpret_cast<uint4*>(p)[k] =
          make_uint4(bf16_pair(v[8 * k], v[8 * k + 1]), bf16_pair(v[8 * k + 2], v[8 * k + 3]),
                     bf16_pair(v[8 * k + 4], v[8 * k + 5]), bf16_pair(v[8 * k + 6], v[8 * k + 7]));
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = __float2bfloat16_rn(v[k]);
  }
}
// int8 codes of v (already quantized to [-128, 127]), four to a word
template <int N>
__device__ __forceinline__ void store_vec(int8_t* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
    unsigned w[N / 4];
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      w[k] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) w[k] |= ((unsigned)(int)v[4 * k + j] & 0xffu) << (8 * j);
    }
    if constexpr (N == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (N == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int k = 0; k < N / 4; ++k) reinterpret_cast<unsigned*>(p)[k] = w[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = (int8_t)(int)v[k];
  }
}

// N channels of a corner row (INSIDE: in the ROI's own map), NaN for a
// corner outside the table
template <bool INSIDE, int N, typename T>
__device__ __forceinline__ void load_corner(const T* row, int c, float (&v)[N]) {
  if (INSIDE || row) {
    load_vec<N>(row + c, v);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = __int_as_float(0x7fc00000);
  }
}

// The forward in every variant. Tin: f32, bf16 or int8 levels; MAP = false:
// the float path (Tout = Tin): weights rounded to the feature type, the sum
// in f32, rounded once at the store. MAP = true: the int8 epilogues, the
// plain version's blend<Tin> times map [ph, pw, C], then int8 codes
// (rint, clip) or bf16 (int8 levels dequantized). Each thread owns N
// consecutive channels (16 bytes of Tin, or 1); THREADS / (C / N) samples are
// in flight per block, and block (roi, split) walks samples
// [split * chunk, (split + 1) * chunk).
template <typename Tin, typename Tout, bool MAP, int N>
__global__ void __launch_bounds__(THREADS)
roi_align_kernel(Pyramid pyr, const float4* __restrict__ boxes, const float* __restrict__ map,
                 Tout* __restrict__ out, int rois_per_image, int channels, int ph, int pw,
                 int chunk, float canonical_scale, float ln2) {
  __shared__ RoiTables s;
  const int roi = blockIdx.x;
  const int img = roi / rois_per_image;
  const bool inside = roi_tables(pyr.dims, boxes[roi], img, ph, pw, canonical_scale, ln2, s);
  const int li = s.level;
  const int H = pyr.dims.h[li], W = pyr.dims.w[li];

  const int vecs = channels / N;     // threads per sample
  const int per = THREADS / vecs;    // samples in flight
  const int slot = threadIdx.x / vecs;
  if (slot >= per) return;
  const int c = (threadIdx.x - slot * vecs) * N;
  const int n = ph * pw;
  const int end = min(n, ((int)blockIdx.y + 1) * chunk);
  int smp = (int)blockIdx.y * chunk + slot;
  int py = smp / pw, px = smp - py * pw;
  const int dpy = per / pw, dpx = per - dpy * pw;

  const Tin* levels[4];
  for (int l = 0; l < 4; ++l) levels[l] = static_cast<const Tin*>(pyr.feat[l]);
  const Tin* feat = static_cast<const Tin*>(pyr.feat[li]) + (size_t)img * H * W * channels;
  Tout* dst = out + (size_t)roi * n * channels + c;
  auto loop = [&](auto direct) {
    constexpr bool kInside = decltype(direct)::value;
    for (; smp < end; smp += per) {
      const float wy = s.wy[py], wx = s.wx[px];
      const float owy = __fsub_rn(1.0f, wy), owx = __fsub_rn(1.0f, wx);
      const Tin* rows[4];
      corner_rows<kInside>(levels, pyr.dims, s, feat, W, py, px, channels, rows);
      float g00[N], g01[N], g10[N], g11[N], o[N];
      load_corner<kInside>(rows[0], c, g00);
      load_corner<kInside>(rows[1], c, g01);
      load_corner<kInside>(rows[2], c, g10);
      load_corner<kInside>(rows[3], c, g11);
      const size_t at = (size_t)smp * channels;
      if constexpr (MAP) {
        const float w00 = __fmul_rn(owy, owx), w01 = __fmul_rn(owy, wx);
        const float w10 = __fmul_rn(wy, owx), w11 = __fmul_rn(wy, wx);
        float m[N];
        load_vec<N>(map + at + c, m);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float v = __fmul_rn(
              blend<Tin>(g00[k], g01[k], g10[k], g11[k], w00, w01, w10, w11), m[k]);
          o[k] = std::is_same<Tout, int8_t>::value ? (float)quantize(v) : v;
        }
      } else {
        const float w00 = to_feat(__fmul_rn(owy, owx), feat);
        const float w01 = to_feat(__fmul_rn(owy, wx), feat);
        const float w10 = to_feat(__fmul_rn(wy, owx), feat);
        const float w11 = to_feat(__fmul_rn(wy, wx), feat);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          float acc = __fmul_rn(g00[k], w00);
          acc = __fadd_rn(acc, __fmul_rn(g01[k], w01));
          acc = __fadd_rn(acc, __fmul_rn(g10[k], w10));
          o[k] = __fadd_rn(acc, __fmul_rn(g11[k], w11));
        }
      }
      store_vec<N>(dst + at, o);
      px += dpx;
      py += dpy;
      if (px >= pw) {
        px -= pw;
        ++py;
      }
    }
  };
  if (inside)
    loop(std::true_type{});
  else
    loop(std::false_type{});
}

__device__ __forceinline__ void scatter(float* row, int c, float v) {
  // adding zero changes no bit of the sum; a corner outside the table
  // (nullptr) gets no gradient, as XLA's scatter drops it
  if (row && v != 0.0f) atomicAdd(row + c, v);
}

// Marks every table row a bilinear corner of the ROI's samples lands on
// (the rows `roi_align._corners` gives, zero weights included): the rows
// the gradient may reach. One block per ROI; the caller zeroed `marks`.
__global__ void __launch_bounds__(THREADS)
roi_align_mark_kernel(Levels dims, const float4* __restrict__ boxes, uint8_t* __restrict__ marks,
                      int rois_per_image, int ph, int pw, float canonical_scale, float ln2) {
  __shared__ RoiTables s;
  const int roi = blockIdx.x;
  roi_tables(dims, boxes[roi], roi / rois_per_image, ph, pw, canonical_scale, ln2, s);
  for (int smp = threadIdx.x; smp < ph * pw; smp += THREADS) {
    const int py = smp / pw, px = smp - py * pw;
    const int t[4] = {wrap_add(s.ty0[py], s.x0[px]), wrap_add(s.ty0[py], s.x1[px]),
                      wrap_add(s.ty1[py], s.x0[px]), wrap_add(s.ty1[py], s.x1[px])};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      long long i = t[k];
      if (i < 0) i += dims.base[4];
      if (i >= 0 && i < dims.base[4]) marks[i] = 1;
    }
  }
}

// Zeroes the f32 rows of `sums` that `marks` marks (every row where marks is
// null). One warp per row, lanes over the channels.
__global__ void __launch_bounds__(THREADS)
roi_align_zero_kernel(SumPyramid sums, const uint8_t* __restrict__ marks, int channels) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * WARPS;
  for (long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); r < sums.dims.base[4];
       r += step) {
    if (marks && !marks[r]) continue;
    float* row = table_row(sums.grad, sums.dims, (int)r, channels);
    if ((channels & 3) == 0) {
      for (int v = lane; v < channels / 4; v += 32)
        reinterpret_cast<float4*>(row)[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      for (int c = lane; c < channels; c += 32) row[c] = 0.0f;
    }
  }
}

// The dense bf16 gradient: each marked row rounded from its f32 sum, every
// other row zero. One warp per row.
__global__ void __launch_bounds__(THREADS)
roi_align_finalize_kernel(SumPyramid sums, OutPyramid<__nv_bfloat16> out,
                          const uint8_t* __restrict__ marks, int channels) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * WARPS;
  for (long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); r < sums.dims.base[4];
       r += step) {
    const bool touched = marks[r];
    const float* src = table_row(sums.grad, sums.dims, (int)r, channels);
    __nv_bfloat16* dst = table_row(out.grad, sums.dims, (int)r, channels);
    if ((channels & 3) == 0) {
      for (int v = lane; v < channels / 4; v += 32) {
        float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (touched) load_vec<4>(src + 4 * v, x);
        store_vec<4>(dst + 4 * v, x);
      }
    } else {
      for (int c = lane; c < channels; c += 32)
        dst[c] = __float2bfloat16_rn(touched ? src[c] : 0.0f);
    }
  }
}

// The rectangle of an in-map ROI's corners on its level (rows y..y+h-1,
// columns x..x+w-1), in shared memory.
struct Footprint {
  int y, x, h, w;
};

__device__ __forceinline__ void footprint(const RoiTables& s, int ph, int pw, Footprint& f) {
  const int t = threadIdx.x, lane = t & 31;
  if (t < 64) {  // warp 0: rows, warp 1: columns
    const bool rows = t < 32;
    int lo = INT_MAX, hi = INT_MIN;
    if (lane < (rows ? ph : pw)) {
      const int a = rows ? s.y0[lane] : s.x0[lane], b = rows ? s.y1[lane] : s.x1[lane];
      lo = min(a, b);
      hi = max(a, b);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      if (rows) {
        f.y = lo;
        f.h = hi - lo + 1;
      } else {
        f.x = lo;
        f.w = hi - lo + 1;
      }
    }
  }
  __syncthreads();
}

constexpr int PREFETCH = 4;  // samples whose grad_out a warp loads at once

// grad_out [batch, rois, ph, pw, C] in the feature type T; sums: the f32
// sums per level, zeroed where the ROIs' corners land. One block per (ROI,
// slice of SLICE channels): lane = channel; warp w takes samples w, w +
// WARPS, ..., PREFETCH of them at a time. Per sample the four corner weights
// (rounded to T) and corner offsets sit in shared memory. A dense in-map
// ROI (footprint of at most SHARED_PIXELS pixels and at most two per
// sample: zero, tiny and small boxes) sums in a shared f32 tile over its
// footprint and adds it to `sums` once per touched (pixel, 4 channels); any
// other ROI adds each contribution to `sums` directly.
template <typename T>
__global__ void __launch_bounds__(THREADS)
roi_align_backward_kernel(SumPyramid sums, const float4* __restrict__ boxes,
                          const T* __restrict__ grad_out, int rois_per_image, int channels,
                          int ph, int pw, float canonical_scale, float ln2) {
  extern __shared__ float4 dyn[];  // [n] weights, [n] corner offsets, the [pixels, SLICE] tile
  __shared__ RoiTables s;
  __shared__ Footprint f;
  const int roi = blockIdx.x;
  const int img = roi / rois_per_image;
  const bool inside = roi_tables(sums.dims, boxes[roi], img, ph, pw, canonical_scale, ln2, s);
  const int li = s.level;
  const int H = sums.dims.h[li], W = sums.dims.w[li];
  const int n = ph * pw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * SLICE;
  const int c = c0 + lane;
  if (inside) footprint(s, ph, pw, f);  // block-uniform: holds a barrier
  const int pixels = inside ? f.h * f.w : 0;
  const bool tiled = inside && pixels <= SHARED_PIXELS && pixels <= 2 * n;

  float4* wts = dyn;
  int4* offs = reinterpret_cast<int4*>(dyn + n);
  float* tile = reinterpret_cast<float*>(dyn + 2 * n);
  for (int smp = threadIdx.x; smp < n; smp += THREADS) {
    const int py = smp / pw, px = smp - py * pw;
    const float wy = s.wy[py], wx = s.wx[px];
    const float owy = __fsub_rn(1.0f, wy), owx = __fsub_rn(1.0f, wx);
    wts[smp] = make_float4(to_feat(__fmul_rn(owy, owx), grad_out),
                           to_feat(__fmul_rn(owy, wx), grad_out),
                           to_feat(__fmul_rn(wy, owx), grad_out),
                           to_feat(__fmul_rn(wy, wx), grad_out));
    if (tiled) {  // pixel indices of the corners in the footprint
      const int r0 = (s.y0[py] - f.y) * f.w, r1 = (s.y1[py] - f.y) * f.w;
      const int q0 = s.x0[px] - f.x, q1 = s.x1[px] - f.x;
      offs[smp] = make_int4(r0 + q0, r0 + q1, r1 + q0, r1 + q1);
    } else {
      offs[smp] = make_int4(py, px, 0, 0);
    }
  }
  if (tiled) {
    for (int i = threadIdx.x; i < pixels * SLICE / 4; i += THREADS)
      reinterpret_cast<float4*>(tile)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  float* grad = sums.grad[li] + (size_t)img * H * W * channels;
  const T* src = grad_out + (size_t)roi * n * channels + c;
  if (c < channels) {
    for (int s0 = warp; s0 < n; s0 += WARPS * PREFETCH) {
      float g[PREFETCH];
#pragma unroll
      for (int u = 0; u < PREFETCH; ++u) {
        const int smp = s0 + u * WARPS;
        float v[1] = {0.0f};
        if (smp < n) load_vec<1>(src + (size_t)smp * channels, v);
        g[u] = v[0];
      }
#pragma unroll
      for (int u = 0; u < PREFETCH; ++u) {
        const int smp = s0 + u * WARPS;
        if (smp >= n) continue;
        const float4 w = wts[smp];
        const int4 o = offs[smp];
        const float v00 = __fmul_rn(g[u], w.x), v01 = __fmul_rn(g[u], w.y);
        const float v10 = __fmul_rn(g[u], w.z), v11 = __fmul_rn(g[u], w.w);
        if (tiled) {
          if (v00 != 0.0f) atomicAdd(&tile[o.x * SLICE + lane], v00);
          if (v01 != 0.0f) atomicAdd(&tile[o.y * SLICE + lane], v01);
          if (v10 != 0.0f) atomicAdd(&tile[o.z * SLICE + lane], v10);
          if (v11 != 0.0f) atomicAdd(&tile[o.w * SLICE + lane], v11);
        } else {
          float* rows[4];
          if (inside)
            corner_rows<true>(sums.grad, sums.dims, s, grad, W, o.x, o.y, channels, rows);
          else
            corner_rows<false>(sums.grad, sums.dims, s, grad, W, o.x, o.y, channels, rows);
          scatter(rows[0], c, v00);
          scatter(rows[1], c, v01);
          scatter(rows[2], c, v10);
          scatter(rows[3], c, v11);
        }
      }
    }
  }
  if (!tiled) return;  // block-uniform
  __syncthreads();
  // flush: one add per (pixel, 4 channels) holding a nonzero (or NaN) sum
  float* base = grad + ((size_t)f.y * W + f.x) * channels + c0;
  const int width = min(SLICE, channels - c0);
  if ((channels & 3) == 0) {
    for (int i = threadIdx.x; i < pixels * (SLICE / 4); i += THREADS) {
      const int p = i / (SLICE / 4), q = 4 * (i % (SLICE / 4));
      if (q >= width) continue;
      const float4 v = *reinterpret_cast<const float4*>(&tile[p * SLICE + q]);
      if (v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f) continue;
      const int yy = p / f.w, xx = p - yy * f.w;
      atomicAdd(reinterpret_cast<float4*>(base + ((size_t)yy * W + xx) * channels + q), v);
    }
  } else {
    for (int i = threadIdx.x; i < pixels * SLICE; i += THREADS) {
      const int p = i / SLICE, q = i % SLICE;
      const float v = tile[i];
      if (q >= width || v == 0.0f) continue;
      const int yy = p / f.w, xx = p - yy * f.w;
      atomicAdd(base + ((size_t)yy * W + xx) * channels + q, v);
    }
  }
}

Levels make_levels(const int* hw, int batch) {
  Levels d;
  d.base[0] = 0;
  d.count = 0;
  for (int l = 0; l < 4; ++l) {
    d.h[l] = hw[2 * l];
    d.w[l] = hw[2 * l + 1];
    d.base[l + 1] = d.base[l] + (long long)batch * d.h[l] * d.w[l];
    if (d.h[l] > 0) d.count = l + 1;
  }
  return d;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// One launch of the forward: N = 16 bytes of Tin where the channels fill
// whole vectors and every pointer is 16-byte aligned, else 1.
template <typename Tin, typename Tout, bool MAP>
int launch(const void* const* feats, const int* hw, const void* boxes, const float* map,
           void* out, int batch, int rois, int channels, int ph, int pw, float canonical_scale,
           float ln2, void* stream) {
  if (batch <= 0 || rois <= 0) return 0;
  if (ph < 1 || pw < 1 || ph > MAX_POOL || pw > MAX_POOL || channels < 1)
    return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(Tin);
  Pyramid pyr;
  bool vec = channels % V == 0 && channels / V <= THREADS && aligned16(out) &&
             (!MAP || aligned16(map));
  for (int l = 0; l < 4; ++l) {
    pyr.feat[l] = feats[l];
    vec = vec && aligned16(feats[l]);
  }
  if (!vec && channels > THREADS) return NO_LAYOUT;
  pyr.dims = make_levels(hw, batch);
  const int n = ph * pw;
  const int per = THREADS / (vec ? channels / V : channels);  // samples in flight
  const int splits = (n + 8 * per - 1) / (8 * per);            // about 8 passes per block
  const int chunk = (n + splits - 1) / splits;
  const dim3 grid(batch * rois, splits);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    roi_align_kernel<Tin, Tout, MAP, V><<<grid, THREADS, 0, st>>>(
        pyr, (const float4*)boxes, map, (Tout*)out, rois, channels, ph, pw, chunk,
        canonical_scale, ln2);
  else
    roi_align_kernel<Tin, Tout, MAP, 1><<<grid, THREADS, 0, st>>>(
        pyr, (const float4*)boxes, map, (Tout*)out, rois, channels, ph, pw, chunk,
        canonical_scale, ln2);
  return (int)cudaGetLastError();
}

int row_blocks(const Levels& d) {
  return (int)std::min<long long>((d.base[4] + WARPS - 1) / WARPS, 8192);
}

// grads: the result per level (f32: they are the sums; bf16: the dense
// rounded gradient, with the sums in `scratch`, [table rows, C] f32, and the
// row marks in `marks`, one byte per table row).
template <typename T>
int launch_backward(const void* grad_out, const int* hw, const void* boxes, void* const* grads,
                    float* scratch, uint8_t* marks, int batch, int rois, int channels, int ph,
                    int pw, float canonical_scale, float ln2, void* stream) {
  if (batch <= 0 || rois <= 0) return 0;
  if (ph < 1 || pw < 1 || ph > MAX_POOL || pw > MAX_POOL || channels < 1)
    return (int)cudaErrorInvalidValue;
  constexpr bool kF32 = std::is_same<T, float>::value;
  cudaStream_t st = (cudaStream_t)stream;
  SumPyramid sums;
  sums.dims = make_levels(hw, batch);
  for (int l = 0; l < 4; ++l)
    sums.grad[l] = kF32 ? (float*)grads[l] : scratch + sums.dims.base[l] * channels;
  const int blocks = batch * rois;
  if (!kF32) {
    cudaError_t e = cudaMemsetAsync(marks, 0, (size_t)sums.dims.base[4], st);
    if (e != cudaSuccess) return (int)e;
    roi_align_mark_kernel<<<blocks, THREADS, 0, st>>>(sums.dims, (const float4*)boxes, marks,
                                                      rois, ph, pw, canonical_scale, ln2);
  }
  roi_align_zero_kernel<<<row_blocks(sums.dims), THREADS, 0, st>>>(
      sums, kF32 ? nullptr : marks, channels);
  const size_t smem = (size_t)ph * pw * 2 * sizeof(float4) + (size_t)SHARED_PIXELS * SLICE * 4;
  cudaError_t e = cudaFuncSetAttribute(roi_align_backward_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  roi_align_backward_kernel<T><<<dim3(blocks, (channels + SLICE - 1) / SLICE), THREADS, smem,
                                 st>>>(sums, (const float4*)boxes, (const T*)grad_out, rois,
                                       channels, ph, pw, canonical_scale, ln2);
  if (!kF32) {
    OutPyramid<__nv_bfloat16> out;
    for (int l = 0; l < 4; ++l) out.grad[l] = (__nv_bfloat16*)grads[l];
    roi_align_finalize_kernel<<<row_blocks(sums.dims), THREADS, 0, st>>>(sums, out, marks,
                                                                        channels);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// feats: 4 device pointers (P2..P5, NHWC contiguous, [batch, h_l, w_l, channels]);
// hw: 8 host ints (h_2, w_2, ..., h_5, w_5; zeros after the last level given,
// whose pointers are not read); boxes: [batch, rois, 4] f32;
// out: [batch, rois, ph, pw, channels] in the feature type.
extern "C" int roi_align_f32(const void* p2, const void* p3, const void* p4, const void* p5,
                             const int* hw, const void* boxes, void* out, int batch, int rois,
                             int channels, int ph, int pw, float canonical_scale, float ln2,
                             void* stream) {
  const void* feats[4] = {p2, p3, p4, p5};
  return launch<float, float, false>(feats, hw, boxes, nullptr, out, batch, rois, channels, ph,
                                     pw, canonical_scale, ln2, stream);
}

extern "C" int roi_align_bf16(const void* p2, const void* p3, const void* p4, const void* p5,
                              const int* hw, const void* boxes, void* out, int batch, int rois,
                              int channels, int ph, int pw, float canonical_scale, float ln2,
                              void* stream) {
  const void* feats[4] = {p2, p3, p4, p5};
  return launch<__nv_bfloat16, __nv_bfloat16, false>(feats, hw, boxes, nullptr, out, batch, rois,
                                                     channels, ph, pw, canonical_scale, ln2,
                                                     stream);
}

// The int8 epilogues. in_kind: 0 f32, 1 bf16, 2 int8 levels; out_kind: 2 int8
// (any input) or 1 bf16 (int8 input only); map: [ph, pw, channels] f32.
extern "C" int roi_align_quant(const void* p2, const void* p3, const void* p4, const void* p5,
                               const int* hw, const void* boxes, const float* map, void* out,
                               int in_kind, int out_kind, int batch, int rois, int channels,
                               int ph, int pw, float canonical_scale, float ln2, void* stream) {
  const void* feats[4] = {p2, p3, p4, p5};
#define ROI_QUANT(TIN, TOUT)                                                                  \
  launch<TIN, TOUT, true>(feats, hw, boxes, map, out, batch, rois, channels, ph, pw,         \
                          canonical_scale, ln2, stream)
  if (out_kind == 2 && in_kind == 0) return ROI_QUANT(float, int8_t);
  if (out_kind == 2 && in_kind == 1) return ROI_QUANT(__nv_bfloat16, int8_t);
  if (out_kind == 2 && in_kind == 2) return ROI_QUANT(int8_t, int8_t);
  if (out_kind == 1 && in_kind == 2) return ROI_QUANT(int8_t, __nv_bfloat16);
#undef ROI_QUANT
  return (int)cudaErrorInvalidValue;
}

// grad_out: [batch, rois, ph, pw, channels] in the feature type; hw and boxes
// as for the forward; g2..g5: the gradient per level [batch, h_l, w_l,
// channels] in the feature type, written whole. bf16 also takes an f32
// scratch of [sum of batch * h_l * w_l, channels] and one byte per row of it
// (marks); f32 takes neither (null).
extern "C" int roi_align_backward_f32(const void* grad_out, const int* hw, const void* boxes,
                                      void* g2, void* g3, void* g4, void* g5, float* scratch,
                                      uint8_t* marks, int batch, int rois, int channels, int ph,
                                      int pw, float canonical_scale, float ln2, void* stream) {
  void* grads[4] = {g2, g3, g4, g5};
  return launch_backward<float>(grad_out, hw, boxes, grads, scratch, marks, batch, rois,
                                channels, ph, pw, canonical_scale, ln2, stream);
}

extern "C" int roi_align_backward_bf16(const void* grad_out, const int* hw, const void* boxes,
                                       void* g2, void* g3, void* g4, void* g5, float* scratch,
                                       uint8_t* marks, int batch, int rois, int channels, int ph,
                                       int pw, float canonical_scale, float ln2, void* stream) {
  void* grads[4] = {g2, g3, g4, g5};
  return launch_backward<__nv_bfloat16>(grad_out, hw, boxes, grads, scratch, marks, batch, rois,
                                        channels, ph, pw, canonical_scale, ln2, stream);
}
