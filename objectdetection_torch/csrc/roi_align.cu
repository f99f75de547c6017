// Multilevel ROIAlign (crop_and_resize bilinear sampling) over an FPN pyramid.
//
// Replaces the Pallas TPU kernel objectdetection_tpu/ops/roi_align_pallas.py
// `_kernel` (entered through `batched_multilevel_roi_align_pallas`). The
// target is the exact XLA semantics of
// objectdetection_tpu/ops/roi_align.py `batched_multilevel_roi_align`:
//   - each box picks a level of P2..P5 by the FPN rule (`roi_levels`):
//     4 + round(log2(sqrt(max(h*w, 1e-12)) / (224 / sqrt(image area)))),
//     zero-area boxes go to P2, clipped to [2, 5];
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
// What bounds it on the H100: bytes. Per image the box stage writes
// 1000x7x7x256 outputs and reads scattered 4-corner rows of P2..P5; the reads
// hit L2 heavily (neighbouring samples share corners). Design: one block per
// ROI; the per-ROI level and the per-row / per-column sample indices and
// weights are computed once into shared memory; threads then run over
// (sample, channel) with the channel fastest, so each corner read and each
// output write is a contiguous run of C values (coalesced, NHWC layout).
//
// Exactness: level, grid and weights are computed in f32 with explicitly
// rounded operations (and --fmad=false), so a sample coordinate cannot move
// across an integer and change floor(). In f32 the corner sum follows the
// plain version's order exactly (bit-equal). In bf16 the products and the sum
// are taken in f32 and rounded once at the end (the plain version rounds to
// bf16 after every op).
//
// The int8 epilogues (`roi_align_quant`) of the serving path: the same
// block layout and tables, then each value times an f32 [ph, pw, C] map
// and, for int8 output, rint + clip to [-128, 127] (quantize_act). Inputs
// are f32 or bf16 levels (the float path's blend, bf16 rounded after every
// product and sum as the plain version rounds, so the codes equal
// quantize_act of the plain pooled tensor), or int8 codes blended in f32 with
// f32 weights (the s_in/127 dequant is in the map). Bit-equal to the plain
// version. What bounds it: bytes, as the float kernel, with 1-byte outputs
// (and 1-byte reads for int8 levels).
//
// The backward (`roi_align_backward_*`) is the gradient with respect to
// P2..P5; the boxes get none, as `jax.lax.stop_gradient(boxes)` gives in
// objectdetection_tpu/ops/roi_align.py. The JAX package has no Pallas kernel
// for it: its gradient is XLA's autodiff of the four-gather sum. Each sample
// scatters w * grad_out into the same four corners, with the same weights
// (rounded to the feature type, as the forward does), by f32 atomicAdd into
// f32 buffers that the caller zeroed; the caller casts them to the feature
// type. What bounds it: bytes, reading grad_out once and writing the dense
// gradient pyramid once. Same block layout as the forward (one block per
// ROI, channel fastest), so a warp's atomics hit 32 consecutive addresses.
// The atomics sum in an order that changes from run to run: the result is
// within a few ulps of the plain backward, not bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "xla_int.cuh"

namespace {

constexpr int MAX_POOL = 32;
constexpr int THREADS = 256;

struct Levels {
  int h[4];
  int w[4];
  long long base[5];  // first table row of each level (batch * h * w rows each); base[4]: length
};

struct Pyramid {
  const void* feat[4];
  Levels dims;
};

struct GradPyramid {
  float* grad[4];
  Levels dims;
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

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f(const int8_t* p, size_t i) { return (float)p[i]; }
__device__ __forceinline__ float to_feat(float v, const float*) { return v; }
__device__ __forceinline__ float to_feat(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
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
    s.level = min(max(lvl, 2), 5) - 2;
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

template <bool INSIDE, typename T>
__device__ __forceinline__ float load_row(const T* row, int c) {
  if (INSIDE) return load_f(row, c);
  return row ? load_f(row, c) : __int_as_float(0x7fc00000);  // NaN
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
roi_align_kernel(Pyramid pyr, const float4* __restrict__ boxes, T* __restrict__ out,
                 int rois_per_image, int channels, int ph, int pw,
                 float canonical_scale, float ln2) {
  __shared__ RoiTables s;
  const int roi = blockIdx.x;
  const int img = roi / rois_per_image;
  const bool inside = roi_tables(pyr.dims, boxes[roi], img, ph, pw, canonical_scale, ln2, s);
  const int li = s.level;
  const int H = pyr.dims.h[li], W = pyr.dims.w[li];

  const T* levels[4];
  for (int l = 0; l < 4; ++l) levels[l] = static_cast<const T*>(pyr.feat[l]);
  const T* feat = static_cast<const T*>(pyr.feat[li]) + (size_t)img * H * W * channels;
  T* dst = out + (size_t)roi * ph * pw * channels;
  const int total = ph * pw * channels;
  auto loop = [&](auto direct) {
    for (int idx = threadIdx.x; idx < total; idx += THREADS) {
      const int c = idx % channels;
      const int smp = idx / channels;
      const int py = smp / pw, px = smp % pw;
      const float wy = s.wy[py], wx = s.wx[px];
      const float owy = __fsub_rn(1.0f, wy), owx = __fsub_rn(1.0f, wx);
      const float w00 = to_feat(__fmul_rn(owy, owx), feat);
      const float w01 = to_feat(__fmul_rn(owy, wx), feat);
      const float w10 = to_feat(__fmul_rn(wy, owx), feat);
      const float w11 = to_feat(__fmul_rn(wy, wx), feat);
      const T* rows[4];
      constexpr bool kInside = decltype(direct)::value;
      corner_rows<kInside>(levels, pyr.dims, s, feat, W, py, px, channels, rows);
      const float g00 = load_row<kInside>(rows[0], c);
      const float g01 = load_row<kInside>(rows[1], c);
      const float g10 = load_row<kInside>(rows[2], c);
      const float g11 = load_row<kInside>(rows[3], c);
      float acc = __fmul_rn(g00, w00);
      acc = __fadd_rn(acc, __fmul_rn(g01, w01));
      acc = __fadd_rn(acc, __fmul_rn(g10, w10));
      acc = __fadd_rn(acc, __fmul_rn(g11, w11));
      store(dst, idx, acc);
    }
  };
  if (inside)
    loop(std::true_type{});
  else
    loop(std::false_type{});
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
__device__ __forceinline__ void store_q(int8_t* p, size_t i, float v) {
  // NaN (a NaN box, or a corner outside the table) converts to 0, as XLA's
  // convert does
  const float q = isnan(v) ? 0.0f : fminf(fmaxf(rintf(v), -128.0f), 127.0f);
  p[i] = (int8_t)(int)q;
}
__device__ __forceinline__ void store_q(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Tin: float, bf16 or int8 levels; Tout: int8 (quantized with the map) or
// bf16 (int8 levels dequantized with the map).
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
roi_align_quant_kernel(Pyramid pyr, const float4* __restrict__ boxes,
                       const float* __restrict__ map, Tout* __restrict__ out,
                       int rois_per_image, int channels, int ph, int pw,
                       float canonical_scale, float ln2) {
  __shared__ RoiTables s;
  const int roi = blockIdx.x;
  const int img = roi / rois_per_image;
  const bool inside = roi_tables(pyr.dims, boxes[roi], img, ph, pw, canonical_scale, ln2, s);
  const int li = s.level;
  const int H = pyr.dims.h[li], W = pyr.dims.w[li];

  const Tin* levels[4];
  for (int l = 0; l < 4; ++l) levels[l] = static_cast<const Tin*>(pyr.feat[l]);
  const Tin* feat = static_cast<const Tin*>(pyr.feat[li]) + (size_t)img * H * W * channels;
  Tout* dst = out + (size_t)roi * ph * pw * channels;
  const int total = ph * pw * channels;
  auto loop = [&](auto direct) {
    for (int idx = threadIdx.x; idx < total; idx += THREADS) {
      const int c = idx % channels;
      const int smp = idx / channels;
      const int py = smp / pw, px = smp % pw;
      const float wy = s.wy[py], wx = s.wx[px];
      const float owy = __fsub_rn(1.0f, wy), owx = __fsub_rn(1.0f, wx);
      const Tin* rows[4];
      constexpr bool kInside = decltype(direct)::value;
      corner_rows<kInside>(levels, pyr.dims, s, feat, W, py, px, channels, rows);
      const float v = blend<Tin>(load_row<kInside>(rows[0], c), load_row<kInside>(rows[1], c),
                                 load_row<kInside>(rows[2], c), load_row<kInside>(rows[3], c),
                                 __fmul_rn(owy, owx), __fmul_rn(owy, wx), __fmul_rn(wy, owx),
                                 __fmul_rn(wy, wx));
      store_q(dst, idx, __fmul_rn(v, map[idx]));
    }
  };
  if (inside)
    loop(std::true_type{});
  else
    loop(std::false_type{});
}

template <bool INSIDE>
__device__ __forceinline__ void scatter(float* row, int c, float v) {
  // adding zero changes no bit of the sum; a corner outside the table
  // (nullptr) gets no gradient, as XLA's scatter drops it
  if ((INSIDE || row) && v != 0.0f) atomicAdd(row + c, v);
}

// grad_out [batch, rois, ph, pw, C] in the feature type T; grads: f32 per
// level, zeroed by the caller.
template <typename T>
__global__ void __launch_bounds__(THREADS)
roi_align_backward_kernel(GradPyramid gp, const float4* __restrict__ boxes,
                          const T* __restrict__ grad_out, int rois_per_image, int channels,
                          int ph, int pw, float canonical_scale, float ln2) {
  __shared__ RoiTables s;
  const int roi = blockIdx.x;
  const int img = roi / rois_per_image;
  const bool inside = roi_tables(gp.dims, boxes[roi], img, ph, pw, canonical_scale, ln2, s);
  const int li = s.level;
  const int H = gp.dims.h[li], W = gp.dims.w[li];

  float* grad = gp.grad[li] + (size_t)img * H * W * channels;
  const T* src = grad_out + (size_t)roi * ph * pw * channels;
  const int total = ph * pw * channels;
  auto loop = [&](auto direct) {
    for (int idx = threadIdx.x; idx < total; idx += THREADS) {
      const int c = idx % channels;
      const int smp = idx / channels;
      const int py = smp / pw, px = smp % pw;
      const float wy = s.wy[py], wx = s.wx[px];
      const float owy = __fsub_rn(1.0f, wy), owx = __fsub_rn(1.0f, wx);
      const float w00 = to_feat(__fmul_rn(owy, owx), src);
      const float w01 = to_feat(__fmul_rn(owy, wx), src);
      const float w10 = to_feat(__fmul_rn(wy, owx), src);
      const float w11 = to_feat(__fmul_rn(wy, wx), src);
      float* rows[4];
      constexpr bool kInside = decltype(direct)::value;
      corner_rows<kInside>(gp.grad, gp.dims, s, grad, W, py, px, channels, rows);
      const float g = load_f(src, idx);
      scatter<kInside>(rows[0], c, __fmul_rn(g, w00));
      scatter<kInside>(rows[1], c, __fmul_rn(g, w01));
      scatter<kInside>(rows[2], c, __fmul_rn(g, w10));
      scatter<kInside>(rows[3], c, __fmul_rn(g, w11));
    }
  };
  if (inside)
    loop(std::true_type{});
  else
    loop(std::false_type{});
}

Levels make_levels(const int* hw, int batch) {
  Levels d;
  d.base[0] = 0;
  for (int l = 0; l < 4; ++l) {
    d.h[l] = hw[2 * l];
    d.w[l] = hw[2 * l + 1];
    d.base[l + 1] = d.base[l] + (long long)batch * d.h[l] * d.w[l];
  }
  return d;
}

template <typename T>
int launch(const void* const* feats, const int* hw, const void* boxes, void* out, int batch,
           int rois, int channels, int ph, int pw, float canonical_scale, float ln2,
           void* stream) {
  if (batch <= 0 || rois <= 0) return 0;
  if (ph < 1 || pw < 1 || ph > MAX_POOL || pw > MAX_POOL) return (int)cudaErrorInvalidValue;
  Pyramid pyr;
  for (int l = 0; l < 4; ++l) pyr.feat[l] = feats[l];
  pyr.dims = make_levels(hw, batch);
  roi_align_kernel<T><<<batch * rois, THREADS, 0, (cudaStream_t)stream>>>(
      pyr, (const float4*)boxes, (T*)out, rois, channels, ph, pw, canonical_scale, ln2);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch_quant(const void* const* feats, const int* hw, const void* boxes, const float* map,
                 void* out, int batch, int rois, int channels, int ph, int pw,
                 float canonical_scale, float ln2, void* stream) {
  if (batch <= 0 || rois <= 0) return 0;
  if (ph < 1 || pw < 1 || ph > MAX_POOL || pw > MAX_POOL) return (int)cudaErrorInvalidValue;
  Pyramid pyr;
  for (int l = 0; l < 4; ++l) pyr.feat[l] = feats[l];
  pyr.dims = make_levels(hw, batch);
  roi_align_quant_kernel<Tin, Tout><<<batch * rois, THREADS, 0, (cudaStream_t)stream>>>(
      pyr, (const float4*)boxes, map, (Tout*)out, rois, channels, ph, pw, canonical_scale, ln2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_backward(const void* grad_out, const int* hw, const void* boxes,
                    float* const* grads, int batch, int rois, int channels, int ph, int pw,
                    float canonical_scale, float ln2, void* stream) {
  if (batch <= 0 || rois <= 0) return 0;
  if (ph < 1 || pw < 1 || ph > MAX_POOL || pw > MAX_POOL) return (int)cudaErrorInvalidValue;
  GradPyramid gp;
  for (int l = 0; l < 4; ++l) gp.grad[l] = grads[l];
  gp.dims = make_levels(hw, batch);
  roi_align_backward_kernel<T><<<batch * rois, THREADS, 0, (cudaStream_t)stream>>>(
      gp, (const float4*)boxes, (const T*)grad_out, rois, channels, ph, pw, canonical_scale,
      ln2);
  return (int)cudaGetLastError();
}

}  // namespace

// feats: 4 device pointers (P2..P5, NHWC contiguous, [batch, h_l, w_l, channels]);
// hw: 8 host ints (h_2, w_2, ..., h_5, w_5); boxes: [batch, rois, 4] f32;
// out: [batch, rois, ph, pw, channels] in the feature type.
extern "C" int roi_align_f32(const void* p2, const void* p3, const void* p4, const void* p5,
                             const int* hw, const void* boxes, void* out, int batch, int rois,
                             int channels, int ph, int pw, float canonical_scale, float ln2,
                             void* stream) {
  const void* feats[4] = {p2, p3, p4, p5};
  return launch<float>(feats, hw, boxes, out, batch, rois, channels, ph, pw, canonical_scale,
                       ln2, stream);
}

extern "C" int roi_align_bf16(const void* p2, const void* p3, const void* p4, const void* p5,
                              const int* hw, const void* boxes, void* out, int batch, int rois,
                              int channels, int ph, int pw, float canonical_scale, float ln2,
                              void* stream) {
  const void* feats[4] = {p2, p3, p4, p5};
  return launch<__nv_bfloat16>(feats, hw, boxes, out, batch, rois, channels, ph, pw,
                               canonical_scale, ln2, stream);
}

// The int8 epilogues. in_kind: 0 f32, 1 bf16, 2 int8 levels; out_kind: 2 int8
// (any input) or 1 bf16 (int8 input only); map: [ph, pw, channels] f32.
extern "C" int roi_align_quant(const void* p2, const void* p3, const void* p4, const void* p5,
                               const int* hw, const void* boxes, const float* map, void* out,
                               int in_kind, int out_kind, int batch, int rois, int channels,
                               int ph, int pw, float canonical_scale, float ln2, void* stream) {
  const void* feats[4] = {p2, p3, p4, p5};
  if (out_kind == 2) {
    if (in_kind == 0)
      return launch_quant<float, int8_t>(feats, hw, boxes, map, out, batch, rois, channels, ph,
                                         pw, canonical_scale, ln2, stream);
    if (in_kind == 1)
      return launch_quant<__nv_bfloat16, int8_t>(feats, hw, boxes, map, out, batch, rois,
                                                 channels, ph, pw, canonical_scale, ln2, stream);
    if (in_kind == 2)
      return launch_quant<int8_t, int8_t>(feats, hw, boxes, map, out, batch, rois, channels, ph,
                                          pw, canonical_scale, ln2, stream);
  } else if (out_kind == 1 && in_kind == 2) {
    return launch_quant<int8_t, __nv_bfloat16>(feats, hw, boxes, map, out, batch, rois,
                                               channels, ph, pw, canonical_scale, ln2, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// grad_out: [batch, rois, ph, pw, channels] in the feature type; hw and boxes
// as for the forward; g2..g5: f32 gradient buffers [batch, h_l, w_l, channels],
// zeroed by the caller, which accumulate the result.
extern "C" int roi_align_backward_f32(const void* grad_out, const int* hw, const void* boxes,
                                      float* g2, float* g3, float* g4, float* g5, int batch,
                                      int rois, int channels, int ph, int pw,
                                      float canonical_scale, float ln2, void* stream) {
  float* grads[4] = {g2, g3, g4, g5};
  return launch_backward<float>(grad_out, hw, boxes, grads, batch, rois, channels, ph, pw,
                                canonical_scale, ln2, stream);
}

extern "C" int roi_align_backward_bf16(const void* grad_out, const int* hw, const void* boxes,
                                       float* g2, float* g3, float* g4, float* g5, int batch,
                                       int rois, int channels, int ph, int pw,
                                       float canonical_scale, float ln2, void* stream) {
  float* grads[4] = {g2, g3, g4, g5};
  return launch_backward<__nv_bfloat16>(grad_out, hw, boxes, grads, batch, rois, channels, ph,
                                        pw, canonical_scale, ln2, stream);
}
