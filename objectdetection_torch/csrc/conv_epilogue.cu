// What follows a float conv of ResNetFPN in inference, in one pass over its output.
//
// Replaces no TPU kernel: XLA fuses these ops into the JAX package's convs
// (objectdetection_tpu/models/backbone.py). cuDNN writes the conv's output y
// (NCHW in channels_last memory, bf16 or f32, C a multiple of 8), and the
// port then ran the bias, BatchNorm's multiply and add, the residual or the
// FPN's upsample-and-add, and ReLU as separate PyTorch kernels, each a read
// and a write of the whole tensor. This kernel applies them in place, in
// the order and the dtype the chain does (ops/conv_epilogue.py):
//   y = y + bias[c]                                         always
//   y = y * inv[c], then y + shift[c]                       BatchNorm
//   y = y + r[b][h][w][c], or + r[b][h >> 1][w >> 1][c]     residual, or the
//                                                           coarser FPN level
//   y = max(y, 0) (NaN kept)                                ReLU
// Each step rounds its f32 result to y's dtype, as each PyTorch op does
// (--fmad=false: no multiply-add is contracted), so the two are bit-equal.
//
// What bounds it on the H100: bytes. It does a few operations for every 2
// or 4 bytes it moves. At batch 96 and 1024^2 one R-101 call rewrites
// 63 GB of conv outputs. The design moves each byte once and keeps the
// memory system busy:
//
// - One read and one write of y, and one read of the residual. The coarser
//   level is read in place at (h >> 1, w >> 1), from L2 for three of its
//   four readers, so no upsampled copy is ever written.
// - 16-byte vectors: a thread owns 8 bf16 or 4 f32 channels of one pixel,
//   and neighbouring threads own neighbouring channel groups, then pixels,
//   so a warp reads and writes 512 contiguous bytes.
// - The grid is as many blocks as the card holds at once, and each thread
//   walks the tensor with a stride that is a multiple of the channel groups
//   a pixel has. So a thread stays on one channel group, and loads its
//   bias, inv and shift once into registers. Each trip of the loop issues
//   U loads (and U residual loads) before it computes, to keep enough bytes
//   in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads a block
constexpr int U = 4;     // 16-byte vectors a thread loads before it computes

// epilogue flags (ops/conv_epilogue.py)
enum { F_BN = 1, F_RES = 2, F_COARSE = 4, F_RELU = 8, F_F32 = 16 };

struct Args {
  uint4* y;              // [B][H][W][C] in y's dtype, rewritten in place
  const uint4* vec[3];   // bias, inv, shift: [C] each in y's dtype (inv, shift only with F_BN)
  const uint4* r;        // [B][H][W][C], or [B][H/2][W/2][C] with F_COARSE
  long long n;           // 16-byte vectors of y
  int groups;            // 16-byte vectors a pixel
  int H, W;
};

// the 4 f32 or 8 bf16 values of a 16-byte vector, as f32
template <bool F32>
__device__ __forceinline__ void unpack(const uint4& q, float* v) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (F32) {
      v[i] = __uint_as_float(w[i]);
    } else {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <bool F32>
__device__ __forceinline__ uint4 pack(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (F32)
      w[i] = __float_as_uint(v[i]);
    else
      w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x rounded to y's dtype, as each PyTorch op rounds its f32 result
template <bool F32>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (F32)
    return x;
  else
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool F32, int F>
__global__ void __launch_bounds__(NT, 4) conv_epilogue_kernel(const Args a) {
  constexpr int V = F32 ? 4 : 8;
  constexpr bool RES = F & (F_RES | F_COARSE);
  const long long stride = (long long)gridDim.x * NT;  // a multiple of a.groups
  const long long pstep = stride / a.groups;           // pixels a stride
  long long i = (long long)blockIdx.x * NT + threadIdx.x;
  const int g = (int)(i % a.groups);
  long long p = i / a.groups;  // the pixel of vector i
  float bias[V], inv[V], shift[V];
  unpack<F32>(__ldg(a.vec[0] + g), bias);
  if (F & F_BN) {
    unpack<F32>(__ldg(a.vec[1] + g), inv);
    unpack<F32>(__ldg(a.vec[2] + g), shift);
  }
  const unsigned H = a.H, W = a.W, hc = H >> 1, wc = W >> 1;
  for (; i < a.n; i += U * stride, p += U * pstep) {
    uint4 yv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = i + u * stride;
      if (j >= a.n) continue;
      yv[u] = a.y[j];
      if (F & F_RES) rv[u] = __ldg(a.r + j);
      if (F & F_COARSE) {
        const unsigned pu = (unsigned)(p + u * pstep);  // < 2^31 pixels
        const unsigned x = pu % W, t = pu / W, h = t % H, b = t / H;
        rv[u] = __ldg(a.r + ((long long)(b * hc + (h >> 1)) * wc + (x >> 1)) * a.groups + g);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = i + u * stride;
      if (j >= a.n) continue;
      float v[V], q[V];
      unpack<F32>(yv[u], v);
      if (RES) unpack<F32>(rv[u], q);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float x = rnd<F32>(v[k] + bias[k]);
        if (F & F_BN) {
          x = rnd<F32>(x * inv[k]);
          x = rnd<F32>(x + shift[k]);
        }
        if (RES) x = rnd<F32>(x + q[k]);
        if (F & F_RELU) x = isnan(x) ? x : fmaxf(x, 0.f);  // PyTorch's clamp_min
        v[k] = x;
      }
      a.y[j] = pack<F32>(v);
    }
  }
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool F32, int F>
int launch(const Args& a, cudaStream_t stream) {
  if constexpr ((F & F_RES) && (F & F_COARSE)) {
    return (int)cudaErrorInvalidValue;
  } else {
    static int resident = 0;  // blocks an SM holds: the kernel's, asked once
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && !resident)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident,
                                                          conv_epilogue_kernel<F32, F>, NT, 0);
    if (err != cudaSuccess) return (int)err;
    // the blocks the card holds at once, fewer where y is small, rounded down
    // (up where that leaves none) to a multiple of groups / gcd(groups, NT),
    // so that the stride blocks * NT is a multiple of groups
    long long want = (a.n + NT - 1) / NT;
    if (want > (long long)sms * resident) want = (long long)sms * resident;
    int m = a.groups, t = NT;
    while (t) {  // m = groups / gcd(groups, NT)
      const int r = m % t;
      m = t;
      t = r;
    }
    m = a.groups / m;
    long long blocks = want / m * m;
    if (blocks == 0) blocks = m;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    conv_epilogue_kernel<F32, F><<<(int)blocks, NT, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
}

template <bool F32, int F = 15>
int dispatch(const Args& a, int flags, cudaStream_t s) {
  if (flags == F) return launch<F32, F>(a, s);
  if constexpr (F > 0) return dispatch<F32, F - 1>(a, flags, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y: [B][H][W][C] (channels_last NCHW), bf16, or f32 with F_F32, rewritten in
// place; vecs: bias, inv, shift, [C] each in y's dtype (inv and shift null
// without F_BN); r: y's shape with F_RES, [B][H/2][W/2][C] with F_COARSE, in
// y's dtype; all 16-byte aligned. dims: B, H, W, C, flags. Returns
// cudaErrorInvalidValue for operands the kernel cannot run.
extern "C" int conv_epilogue(void* y, const void* const* vecs, const void* r, const int* dims,
                             void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  const int B = dims[0], H = dims[1], W = dims[2], C = dims[3], flags = dims[4];
  const bool f32 = flags & F_F32;
  const int v = f32 ? 4 : 8, f = flags & 15;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % v || flags & ~31) return bad;
  if ((f & F_RES) && (f & F_COARSE)) return bad;
  if ((f & F_COARSE) && (H % 2 || W % 2)) return bad;
  if (!y || !aligned(y) || !vecs[0] || !aligned(vecs[0])) return bad;
  if ((f & F_BN) && (!vecs[1] || !vecs[2] || !aligned(vecs[1]) || !aligned(vecs[2]))) return bad;
  if ((f & (F_RES | F_COARSE)) && (!r || !aligned(r))) return bad;
  const long long pixels = (long long)B * H * W;
  if (pixels > 0x7fffffff) return bad;
  Args a;
  a.y = (uint4*)y;
  for (int i = 0; i < 3; ++i) a.vec[i] = (const uint4*)vecs[i];
  a.r = (const uint4*)r;
  a.groups = C / v;
  a.n = pixels * a.groups;
  a.H = H;
  a.W = W;
  cudaStream_t s = (cudaStream_t)stream;
  return f32 ? dispatch<true>(a, f, s) : dispatch<false>(a, f, s);
}
