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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_POOL = 32;
constexpr int THREADS = 256;

struct Pyramid {
  const void* feat[4];
  int h[4];
  int w[4];
};

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
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
  int i0 = (int)f;
  int i1 = min(i0 + 1, size - 1);
  i0 = min(max(i0, 0), size - 1);
  *i0_out = i0;
  *i1_out = i1;
  *w_out = w1;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
roi_align_kernel(Pyramid pyr, const float4* __restrict__ boxes, T* __restrict__ out,
                 int rois_per_image, int channels, int ph, int pw,
                 float canonical_scale, float ln2) {
  __shared__ int s_y0[MAX_POOL], s_y1[MAX_POOL], s_x0[MAX_POOL], s_x1[MAX_POOL];
  __shared__ float s_wy[MAX_POOL], s_wx[MAX_POOL];
  __shared__ int s_level;

  const int roi = blockIdx.x;
  const int img = roi / rois_per_image;
  const float4 b = boxes[roi];  // (y1, x1, y2, x2)
  const float bh = __fsub_rn(b.z, b.x);
  const float bw = __fsub_rn(b.w, b.y);

  if (threadIdx.x == 0) {
    const float area = __fmul_rn(bh, bw);
    int lvl = 2;
    if (area > 0.0f) {
      const float scale = __fdiv_rn(__fsqrt_rn(fmaxf(area, 1e-12f)), canonical_scale);
      const float l2 = __fdiv_rn(logf(scale), ln2);
      lvl = 4 + (int)rintf(l2);
    }
    s_level = min(max(lvl, 2), 5) - 2;
  }
  __syncthreads();
  const int li = s_level;
  const int H = pyr.h[li], W = pyr.w[li];
  const int t = threadIdx.x;
  if (t < ph) axis_sample(b.x, b.z, H, ph, t, &s_y0[t], &s_y1[t], &s_wy[t]);
  if (t >= MAX_POOL && t - MAX_POOL < pw) {
    const int j = t - MAX_POOL;
    axis_sample(b.y, b.w, W, pw, j, &s_x0[j], &s_x1[j], &s_wx[j]);
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(pyr.feat[li]) + (size_t)img * H * W * channels;
  T* dst = out + (size_t)roi * ph * pw * channels;
  const int total = ph * pw * channels;
  for (int idx = t; idx < total; idx += THREADS) {
    const int c = idx % channels;
    const int s = idx / channels;
    const int py = s / pw, px = s % pw;
    const float wy = s_wy[py], wx = s_wx[px];
    const float owy = __fsub_rn(1.0f, wy), owx = __fsub_rn(1.0f, wx);
    const float w00 = to_feat(__fmul_rn(owy, owx), feat);
    const float w01 = to_feat(__fmul_rn(owy, wx), feat);
    const float w10 = to_feat(__fmul_rn(wy, owx), feat);
    const float w11 = to_feat(__fmul_rn(wy, wx), feat);
    const size_t r0 = (size_t)s_y0[py] * W, r1 = (size_t)s_y1[py] * W;
    const size_t c0 = (size_t)s_x0[px], c1 = (size_t)s_x1[px];
    const float g00 = load_f(feat, (r0 + c0) * channels + c);
    const float g01 = load_f(feat, (r0 + c1) * channels + c);
    const float g10 = load_f(feat, (r1 + c0) * channels + c);
    const float g11 = load_f(feat, (r1 + c1) * channels + c);
    float acc = __fmul_rn(g00, w00);
    acc = __fadd_rn(acc, __fmul_rn(g01, w01));
    acc = __fadd_rn(acc, __fmul_rn(g10, w10));
    acc = __fadd_rn(acc, __fmul_rn(g11, w11));
    store(dst, idx, acc);
  }
}

template <typename T>
int launch(const void* const* feats, const int* hw, const void* boxes, void* out, int batch,
           int rois, int channels, int ph, int pw, float canonical_scale, float ln2,
           void* stream) {
  if (batch <= 0 || rois <= 0) return 0;
  if (ph < 1 || pw < 1 || ph > MAX_POOL || pw > MAX_POOL) return (int)cudaErrorInvalidValue;
  Pyramid pyr;
  for (int l = 0; l < 4; ++l) {
    pyr.feat[l] = feats[l];
    pyr.h[l] = hw[2 * l];
    pyr.w[l] = hw[2 * l + 1];
  }
  roi_align_kernel<T><<<batch * rois, THREADS, 0, (cudaStream_t)stream>>>(
      pyr, (const float4*)boxes, (T*)out, rois, channels, ph, pw, canonical_scale, ln2);
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
