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
// m1 is zero outside the image (SAME padding of the 3x3's input). The
// per-channel f32 affines come from the host (ops/fused_block.py); every
// epilogue operation is explicitly rounded (--fmad=false), so the result is
// bit-equal to the plain PyTorch version.
//
// What bounds it on the H100: per call it must read the int8 input and write
// the int8 output once (2 x 33.6 MB at B=2 in R101's stage 2 at 1024^2, half
// that per later stage) against 9.13 GMAC of int8 work at every stage (~9 us
// at the int8 tensor-core peak): bytes in stages 2-3, operations in 4-5
// (ops/fused_block.py `block_bound`). Design (the
// simple first version): one block per output row; the three m1 rows the
// 3x3 needs are computed into shared memory from one staged input row at a
// time (so m1 is recomputed for 3 output rows: 3x the 1x1's work), then the
// m2 row, then the output row with the shortcut read from global memory. The
// intermediates never leave shared memory. Threads run over (pixel group,
// output channel), channel fastest: 16-byte weight loads are coalesced across
// a warp (weights packed [K/16][N][16] on the host, read through L1/L2),
// activations are broadcast reads of shared memory, and each thread keeps
// PIX accumulators so that one weight load serves PIX pixels. The int8
// products are __dp4a (exact int32). Not yet used: int8 tensor cores
// (wgmma/mma), TMA, multi-row tiles without the halo recompute.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;  // threads per block
constexpr int PIX = 8;   // pixels per thread unit

__device__ __forceinline__ int dot16(const int4 a, const int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// min(rint(max(v, 0)), 127) as int8, rint rounding half to even
__device__ __forceinline__ int8_t to_code(float v) {
  return (int8_t)(int)fminf(rintf(fmaxf(v, 0.0f)), 127.0f);
}

__device__ __forceinline__ int8_t requant(int t, float a, float b) {
  return to_code(__fadd_rn(__fmul_rn(__int2float_rn(t), a), b));
}

__global__ void __launch_bounds__(NT)
fused_block_kernel(const int8_t* __restrict__ x, const int4* __restrict__ ka,
                   const int4* __restrict__ kb, const int4* __restrict__ kc,
                   const float* __restrict__ alpha_a, const float* __restrict__ beta_a,
                   const float* __restrict__ alpha_b, const float* __restrict__ beta_b,
                   const float* __restrict__ alpha_c, const float* __restrict__ beta_c,
                   const float* __restrict__ sc_short, int8_t* __restrict__ out, int H, int W,
                   int C3, int C1) {
  extern __shared__ int4 smem[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);  // one input row [W][C3]
  int8_t* m1 = xs + (size_t)W * C3;              // rows y-1, y, y+1 [3][W][C1]
  int8_t* m2 = m1 + (size_t)3 * W * C1;          // [W][C1]
  const int b = blockIdx.x / H;
  const int y = blockIdx.x % H;
  const int8_t* ximg = x + (size_t)b * H * W * C3;
  const int K3 = C3 / 16, K1 = C1 / 16;
  const int groups = (W + PIX - 1) / PIX;

  // ---- conv 2a (1x1) + requant, for the three m1 rows of the 3x3
  for (int r = 0; r < 3; ++r) {
    const int yy = y - 1 + r;
    int8_t* m1r = m1 + (size_t)r * W * C1;
    if (yy < 0 || yy >= H) {  // SAME padding: zero rows (uniform branch)
      for (int i = threadIdx.x; i < W * C1 / 16; i += NT)
        reinterpret_cast<int4*>(m1r)[i] = make_int4(0, 0, 0, 0);
      continue;
    }
    const int4* src = reinterpret_cast<const int4*>(ximg + (size_t)yy * W * C3);
    for (int i = threadIdx.x; i < W * C3 / 16; i += NT) reinterpret_cast<int4*>(xs)[i] = src[i];
    __syncthreads();
    for (int u = threadIdx.x; u < groups * C1; u += NT) {
      const int c = u % C1;
      const int px0 = (u / C1) * PIX;
      int acc[PIX];
#pragma unroll
      for (int p = 0; p < PIX; ++p) acc[p] = 0;
      for (int k = 0; k < K3; ++k) {
        const int4 wv = ka[(size_t)k * C1 + c];
#pragma unroll
        for (int p = 0; p < PIX; ++p) {
          if (px0 + p < W) {
            const int4 xv = reinterpret_cast<const int4*>(xs + (size_t)(px0 + p) * C3)[k];
            acc[p] = dot16(xv, wv, acc[p]);
          }
        }
      }
      const float a = alpha_a[c], bb = beta_a[c];
#pragma unroll
      for (int p = 0; p < PIX; ++p)
        if (px0 + p < W) m1r[(size_t)(px0 + p) * C1 + c] = requant(acc[p], a, bb);
    }
    __syncthreads();
  }
  __syncthreads();  // the zero rows too are written before the 3x3 reads them

  // ---- conv 2b (3x3 over the m1 rows, zero outside the columns) + requant
  for (int u = threadIdx.x; u < groups * C1; u += NT) {
    const int c = u % C1;
    const int px0 = (u / C1) * PIX;
    int acc[PIX];
#pragma unroll
    for (int p = 0; p < PIX; ++p) acc[p] = 0;
    for (int dy = 0; dy < 3; ++dy) {
      const int8_t* m1r = m1 + (size_t)dy * W * C1;
      for (int dx = 0; dx < 3; ++dx) {
        const int4* wrow = kb + (size_t)(dy * 3 + dx) * K1 * C1 + c;
        for (int k = 0; k < K1; ++k) {
          const int4 wv = wrow[(size_t)k * C1];
#pragma unroll
          for (int p = 0; p < PIX; ++p) {
            const int col = px0 + p + dx - 1;
            if (px0 + p < W && col >= 0 && col < W) {
              const int4 xv = reinterpret_cast<const int4*>(m1r + (size_t)col * C1)[k];
              acc[p] = dot16(xv, wv, acc[p]);
            }
          }
        }
      }
    }
    const float a = alpha_b[c], bb = beta_b[c];
#pragma unroll
    for (int p = 0; p < PIX; ++p)
      if (px0 + p < W) m2[(size_t)(px0 + p) * C1 + c] = requant(acc[p], a, bb);
  }
  __syncthreads();

  // ---- conv 2c (1x1) + BN + shortcut + relu + requant
  const float sc = *sc_short;
  const int8_t* xrow = ximg + (size_t)y * W * C3;
  int8_t* orow = out + ((size_t)b * H + y) * W * C3;
  for (int u = threadIdx.x; u < groups * C3; u += NT) {
    const int c = u % C3;
    const int px0 = (u / C3) * PIX;
    int acc[PIX];
#pragma unroll
    for (int p = 0; p < PIX; ++p) acc[p] = 0;
    for (int k = 0; k < K1; ++k) {
      const int4 wv = kc[(size_t)k * C3 + c];
#pragma unroll
      for (int p = 0; p < PIX; ++p) {
        if (px0 + p < W) {
          const int4 xv = reinterpret_cast<const int4*>(m2 + (size_t)(px0 + p) * C1)[k];
          acc[p] = dot16(xv, wv, acc[p]);
        }
      }
    }
    const float a = alpha_c[c], bb = beta_c[c];
#pragma unroll
    for (int p = 0; p < PIX; ++p) {
      if (px0 + p < W) {
        const size_t i = (size_t)(px0 + p) * C3 + c;
        const float t = __fadd_rn(__fmul_rn(__int2float_rn(acc[p]), a), bb);
        orow[i] = to_code(__fadd_rn(t, __fmul_rn((float)xrow[i], sc)));
      }
    }
  }
}

}  // namespace

// x, out: [batch, H, W, C3] int8 NHWC contiguous; ka: [C3/16][C1][16],
// kb: [9*C1/16][C1][16] (rows (dy, dx, ci)-major), kc: [C1/16][C3][16] int8;
// alpha/beta: f32 [C1] (a, b) and [C3] (c); sc_short: one f32 on the device.
extern "C" int fused_block_int8(const void* x, const void* ka, const void* kb, const void* kc,
                                const float* alpha_a, const float* beta_a,
                                const float* alpha_b, const float* beta_b,
                                const float* alpha_c, const float* beta_c,
                                const float* sc_short, void* out, int batch, int H, int W,
                                int C3, int C1, void* stream) {
  if (batch <= 0) return 0;
  if (H <= 0 || W <= 0 || C3 <= 0 || C1 <= 0 || C3 % 16 || C1 % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)W * C3 + (size_t)4 * W * C1;
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_block_kernel<<<batch * H, NT, smem, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int4*)ka, (const int4*)kb, (const int4*)kc, alpha_a, beta_a,
      alpha_b, beta_b, alpha_c, beta_c, sc_short, (int8_t*)out, H, W, C3, C1);
  return (int)cudaGetLastError();
}
