// Int8 convolution as one implicit GEMM with its epilogue fused (int8 serving path).
//
// Replaces no TPU kernel: the JAX package leaves the int8 conv to XLA
// (objectdetection_tpu/quant.py), and the port computed it as an im2col
// matrix, a library int8 GEMM (torch._int_mm) and about eight elementwise
// passes over device memory. For an int8 NHWC input x, an int8 kernel W
// (K-major [N][K] rows, K = (dy, dx, ci), the OHWI layout of the im2col's
// columns), stride and explicit pads, this kernel computes the exact int32
// sums acc[m][n] over M = B*Ho*Wo pixels, N = cout and K = kh*kw*cin, and
// writes what the conv's consumer reads (ops/int8_conv.py, in this order):
//   y = bf16(f32(acc) * post[n]) + bf16(bias[n])            always
//   y = bf16(y * inv[n]) + shift[n]                           BatchNorm
//   y = y + r, r a bf16 tensor or bf16(f32(x8r) * rs[n])      residual
//   y = max(y, 0)                                             ReLU
//   out = y (the compute dtype) or clamp(rint(f32(y) * f[n]), -128, 127)
// Every operation rounds where the plain PyTorch version rounds (bf16 after
// each op, or nothing in f32 compute; --fmad=false), so the two are
// bit-equal; the integer sums are exact (K <= 18432 here: |acc| < 2^31).
//
// What bounds it on the H100 at the main path's shapes (batch 96, 1024^2):
// bytes in ResNet stages 2-3 (a 1x1 conv of 64 channels does ~100 int8
// operations a byte against the card's ~590), operations in stages 4-5,
// the RPN's shared 3x3 conv and the mask head's 14x14 3x3 convs. What the
// design does about each:
//
// - Bytes. No im2col matrix and no f32 or bf16 intermediate exists in device
//   memory: each 16-byte piece of the A tile is copied by cp.async straight
//   from the NHWC input at its tap's address (zero-filled for padding taps,
//   ragged edges and K past its end), and the epilogue works on the
//   accumulators in registers. The input is read once from device memory (a
//   3x3 conv's nine taps hit L2), the output written once in its consumer's
//   type, int8 inside a bottleneck block. The N tiles of one M tile are
//   neighbours in the grid, so they share the A tile through L2. The
//   residual tile arrives in shared memory in one round of 16-byte copies
//   while the epilogue's first operations run, and the output tile leaves
//   through shared memory in 16-byte stores (a lane's own pairs would take
//   a round trip each, and 2-byte stores).
// - Operations. mma.sync m16n8k32 s8 on the tensor cores; A and B fragments
//   come from shared memory with ldmatrix, rows padded by 16 bytes so that
//   ldmatrix's 8 rows meet no bank twice; a four-stage cp.async ring keeps
//   three K chunks in flight while one is multiplied. A block of 8 warps
//   owns BM pixels x BN channels, chosen by the wrapper from M and N: a
//   warp owns 64 x 32 of them ((128, 128), or (256, 64) for N up to 64),
//   fewer where N or the grid is small. Each thread copies its A pieces by
//   a table of the tile's pixels in shared memory, and walks its taps
//   incrementally, so the K loop holds no division.
//
// Not used: wgmma, TMA, warp specialisation, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;       // bytes of K a stage
constexpr int STAGES = 4;    // cp.async ring
constexpr int LD = BK + 16;  // shared row stride (bytes): ldmatrix without bank conflicts
constexpr int NT = 256;      // threads a block (8 warps)
constexpr int NVEC = 6;      // post, bias, inv, shift, rs, f

// epilogue flags (ops/int8_conv.py FLAGS)
enum { F_BN = 1, F_RES_FLOAT = 2, F_RES_INT8 = 4, F_RELU = 8, F_OUT_INT8 = 16, F_F32 = 32 };

struct Args {
  const int8_t* x;         // [B][H][W][C]
  const int8_t* w;         // [N][K]
  const float* vec[NVEC];  // [N] each, or null where the epilogue does not use it
  const void* res;         // [M][N]: the compute dtype, or int8
  void* out;               // [M][N]: the compute dtype, or int8
  int H, W, C, Ho, Wo, N, K, M, KW, stride, pad_t, pad_l, flags;
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
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// the compute dtype's rounding of an f32 result: bf16 (round to nearest
// even, as PyTorch's cast), or none in f32
__device__ __forceinline__ float rnd(float v, bool f32) {
  return f32 ? v : __bfloat162float(__float2bfloat16_rn(v));
}

// the epilogue above up to the residual, on the int32 sum t of the tile's
// column nl (sv: the block's [NVEC][BN] vectors)
__device__ __forceinline__ float head(int t, const float* sv, int nl, int bn, int flags) {
  const bool f32 = flags & F_F32;
  float y = rnd(__fmul_rn(__int2float_rn(t), sv[nl]), f32);
  y = rnd(__fadd_rn(y, sv[bn + nl]), f32);
  if (flags & F_BN) {
    y = rnd(__fmul_rn(y, sv[2 * bn + nl]), f32);
    y = rnd(__fadd_rn(y, sv[3 * bn + nl]), f32);
  }
  return y;
}

// the rest: the residual r and ReLU
__device__ __forceinline__ float tail(float y, float r, int flags) {
  if (flags & (F_RES_FLOAT | F_RES_INT8)) y = rnd(__fadd_rn(y, r), flags & F_F32);
  if ((flags & F_RELU) && y < 0.0f) y = 0.0f;  // NaN passes, as torch.relu
  return y;
}

// the residual of two neighbouring columns at p (shared or device memory):
// two int8 codes dequantized with rs, or two values of the compute dtype
__device__ __forceinline__ float2 residual(const void* p, int flags, float rs0, float rs1) {
  const bool f32 = flags & F_F32;
  if (flags & F_RES_INT8) {
    const char2 x = *static_cast<const char2*>(p);
    return make_float2(rnd(__fmul_rn((float)x.x, rs0), f32), rnd(__fmul_rn((float)x.y, rs1), f32));
  }
  if (f32) return *static_cast<const float2*>(p);
  const __nv_bfloat162 x = *static_cast<const __nv_bfloat162*>(p);
  return make_float2(__bfloat162float(x.x), __bfloat162float(x.y));
}

// rint(f32(y) * f), clamped to [-128, 127] (the conversion saturates)
__device__ __forceinline__ int8_t quantize(float y, float f) {
  return (int8_t)max(-128, min(127, __float2int_rn(__fmul_rn(y, f))));
}

// the output of two neighbouring columns at p: int8 codes quantized with f,
// or the compute dtype (y0, y1 are bf16 values already in bf16: exact)
__device__ __forceinline__ void store(void* p, float y0, float y1, int flags, float f0,
                                      float f1) {
  if (flags & F_OUT_INT8)
    *static_cast<char2*>(p) = make_char2(quantize(y0, f0), quantize(y1, f1));
  else if (flags & F_F32)
    *static_cast<float2*>(p) = make_float2(y0, y1);
  else
    *static_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
}

// 4-byte async copy (a vector element), zero-filled when !pred
__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// the block's shared memory: the cp.async ring, the N tile's vectors, and a
// table of the M tile's pixels (their image's first pixel and the tap
// origin); the ring later stages the residual and output tiles
template <int BM, int BN>
struct Smem {
  static constexpr int A_STAGE = BM * LD, B_STAGE = BN * LD;
  static constexpr int SV = STAGES * (A_STAGE + B_STAGE);    // [NVEC][BN] f32
  static constexpr int ROWS = SV + NVEC * BN * 4;           // [BM] int4
  static constexpr int BYTES = ROWS + BM * 16;
  static constexpr int SLD = BN * 2 + 16;  // row stride of the staged tiles
  static_assert(2 * BM * SLD <= SV, "the staged tiles fit the ring");
};

// EPI: the epilogue's flags fixed at compile time (the main path's five
// epilogues in bf16), or -1 to read them from the arguments
template <int BM, int BN, int EPI>
__global__ void __launch_bounds__(NT, BM * BN <= 128 * 64 ? 3 : 2) int8_conv_kernel(const Args a) {
  using S = Smem<BM, BN>;
  constexpr int WN = BN / 32;        // warps along N (32 channels each)
  constexpr int WM = 8 / WN;         // warps along M
  constexpr int TM = BM / WM / 16;   // 16-row tiles a warp
  constexpr int ROWS_T = BM / 64;    // A rows a thread copies a K chunk
  constexpr int A_STAGE = S::A_STAGE, B_STAGE = S::B_STAGE, SLD = S::SLD;
  extern __shared__ int4 smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + STAGES * A_STAGE;
  float* sv = reinterpret_cast<float*>(As + S::SV);
  int4* rows = reinterpret_cast<int4*>(As + S::ROWS);

  const int ntn = (a.N + BN - 1) / BN;
  const int mt = blockIdx.x / ntn, nt = blockIdx.x - mt * ntn;
  const int m0 = mt * BM, n0 = nt * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // each pixel of the tile: (its image's first pixel, iy0, ix0, -) with
  // iy0, ix0 the input position of tap (0, 0); a pixel past M has every tap
  // out of the image
  const int howo = a.Ho * a.Wo;
  for (int r = tid; r < BM; r += NT) {
    const int m = m0 + r;
    const int b = m / howo, rem = m - b * howo;
    const int oy = rem / a.Wo, ox = rem - oy * a.Wo;
    rows[r] = m < a.M ? make_int4(b * a.H * a.W, oy * a.stride - a.pad_t,
                                  ox * a.stride - a.pad_l, 0)
                      : make_int4(0, -(1 << 30), 0, 0);
  }
  __syncthreads();

  // this thread copies its 16-byte piece (tid % 4) of rows tid / 4 + 64 j;
  // (kk, dy, dx, ci): that piece's K offset and tap in the next K chunk
  const int piece = tid & 3;
  int kk = piece * 16;
  int tap = kk / a.C, ci = kk - tap * a.C;
  int dy = tap / a.KW, dx = tap - dy * a.KW;

  auto load = [&](int slot, int kt) {
    int8_t* as = As + slot * A_STAGE;
#pragma unroll
    for (int j = 0; j < ROWS_T; ++j) {
      const int r = (tid >> 2) + j * 64;
      const int4 row = rows[r];
      const int iy = row.y + dy, ix = row.z + dx;
      const bool ok = kk < a.K && (unsigned)iy < (unsigned)a.H && (unsigned)ix < (unsigned)a.W;
      cp16(as + r * LD + piece * 16,
           ok ? a.x + ((long long)row.x + (long long)iy * a.W + ix) * a.C + ci : a.x, ok);
    }
    kk += BK;
    ci += BK;
    while (ci >= a.C) {  // at most BK / 16 steps (C >= 16)
      ci -= a.C;
      if (++dx == a.KW) {
        dx = 0;
        ++dy;
      }
    }
    int8_t* bs = Bs + slot * B_STAGE;
    const int k0 = kt * BK;
    for (int i = tid; i < BN * 4; i += NT) {
      const int n = i >> 2, c = i & 3;
      const int kb = k0 + c * 16;
      const bool ok = n0 + n < a.N && kb < a.K;
      cp16(bs + n * LD + c * 16, ok ? a.w + (long long)(n0 + n) * a.K + kb : a.w, ok);
    }
  };

  // the N tile's vectors ride with the first K chunk
  for (int i = tid; i < NVEC * BN; i += NT) {
    const int v = i / BN, n = n0 + i - v * BN;
    const bool ok = a.vec[v] != nullptr && n < a.N;
    cp4(sv + i, ok ? a.vec[v] + n : a.vec[0], ok);
  }

  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, tig = lane & 3;
  // this lane's ldmatrix rows: A (16 rows, two 16-byte halves of a k32 step),
  // B (16 channels, two halves)
  const uint32_t a_lane = smem_u32(As) + ((wm * TM * 16 + (lane & 15)) * LD + (lane >> 4) * 16);
  const uint32_t b_lane = smem_u32(Bs) + ((wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                          ((lane >> 3) & 1) * 16);

  int acc[TM][4][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  const int KT = (a.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();  // chunk kt has landed (this thread's copies)
    __syncthreads();        // and everyone's; the slot of chunk kt - 1 is free
    if (kt + STAGES - 1 < KT) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_commit();
    const int slot = kt % STAGES;
    const uint32_t as = a_lane + slot * A_STAGE, bs = b_lane + slot * B_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) ldsm4(bs + h * 16 * LD + ks * 32, b[h]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        uint32_t af[4];
        ldsm4(as + i * 16 * LD + ks * 32, af);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_s8(acc[i][2 * h], af, b[h][0], b[h][1]);
          mma_s8(acc[i][2 * h + 1], af, b[h][2], b[h][3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it stages the residual and output tiles

  // A tile whose rows are whole 16-byte pieces (bf16 or int8, 16 | row bytes)
  // is staged in shared memory: the residual comes in one round of 16-byte
  // copies while the epilogue's head runs, the output leaves in 16-byte
  // stores. Others (f32, the RPN head's 18 bf16 columns) go pair by pair.
  const int flags = EPI >= 0 ? EPI : a.flags;
  const bool f32 = flags & F_F32, res_int8 = flags & F_RES_INT8;
  const int relem = res_int8 ? 1 : f32 ? 4 : 2, oelem = (flags & F_OUT_INT8) ? 1 : f32 ? 4 : 2;
  const bool has_res = flags & (F_RES_FLOAT | F_RES_INT8);
  const bool stage_res = has_res && relem <= 2 && (a.N * relem) % 16 == 0;
  const bool stage_out = oelem <= 2 && (a.N * oelem) % 16 == 0;
  int8_t* rtile = As;              // [BM][SLD]
  int8_t* otile = As + BM * SLD;  // [BM][SLD]
  if (stage_res) {
    const int pieces = BN * relem / 16;
    for (int i = tid; i < BM * pieces; i += NT) {
      const int r = i / pieces, c = i - r * pieces;
      const int m = m0 + r, n = n0 + c * 16 / relem;
      const bool ok = m < a.M && n < a.N;
      cp16(rtile + r * SLD + c * 16,
           ok ? static_cast<const int8_t*>(a.res) + ((long long)m * a.N + n) * relem : a.res,
           ok);
    }
    cp_commit();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        acc[i][j][v] =
            __float_as_int(head(acc[i][j][v], sv, wn * 32 + j * 8 + tig * 2 + (v & 1), BN, flags));
  if (stage_res) {
    cp_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nl = wn * 32 + j * 8 + tig * 2;  // column pair (nl, nl + 1) of the tile
    const int n = n0 + nl;
    if (n >= a.N) continue;  // N is even: n + 1 < N too
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm * TM * 16 + i * 16 + g + h * 8, m = m0 + rl;
        if (m >= a.M) continue;
        const long long o = (long long)m * a.N + n;
        float2 r = make_float2(0.0f, 0.0f);
        if (has_res)
          r = residual(stage_res ? (const void*)(rtile + rl * SLD + nl * relem)
                                 : (const void*)(static_cast<const int8_t*>(a.res) + o * relem),
                       flags, sv[4 * BN + nl], sv[4 * BN + nl + 1]);
        store(stage_out ? (void*)(otile + rl * SLD + nl * oelem)
                        : (void*)(static_cast<int8_t*>(a.out) + o * oelem),
              tail(__int_as_float(acc[i][j][2 * h]), r.x, flags),
              tail(__int_as_float(acc[i][j][2 * h + 1]), r.y, flags), flags, sv[5 * BN + nl],
              sv[5 * BN + nl + 1]);
      }
    }
  }
  if (stage_out) {
    __syncthreads();
    const int pieces = BN * oelem / 16;
    for (int i = tid; i < BM * pieces; i += NT) {
      const int r = i / pieces, c = i - r * pieces;
      const int m = m0 + r, n = n0 + c * 16 / oelem;
      if (m < a.M && n < a.N)
        *reinterpret_cast<int4*>(static_cast<int8_t*>(a.out) + ((long long)m * a.N + n) * oelem) =
            *reinterpret_cast<const int4*>(otile + r * SLD + c * 16);
    }
  }
}

template <int BM, int BN, int EPI>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = Smem<BM, BN>::BYTES;  // above 48 KB: opt in (on the current device)
  const cudaError_t err = cudaFuncSetAttribute(
      int8_conv_kernel<BM, BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)((a.M + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int8_conv_kernel<BM, BN, EPI><<<(int)grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the main path's epilogues (bf16): QuantConv's bias, the projection's
// BatchNorm, conv 2a/2b, conv 2c with a bf16 or an int8 residual; any other
// reads its flags at run time
constexpr int EPI_PROJ = F_BN, EPI_AB = F_BN | F_RELU | F_OUT_INT8;
constexpr int EPI_C_PROJ = EPI_AB | F_RES_FLOAT, EPI_C_ID = EPI_AB | F_RES_INT8;

template <int BM, int BN>
int dispatch(const Args& a, cudaStream_t s) {
  switch (a.flags) {
    case 0: return launch<BM, BN, 0>(a, s);
    case EPI_PROJ: return launch<BM, BN, EPI_PROJ>(a, s);
    case EPI_AB: return launch<BM, BN, EPI_AB>(a, s);
    case EPI_C_PROJ: return launch<BM, BN, EPI_C_PROJ>(a, s);
    case EPI_C_ID: return launch<BM, BN, EPI_C_ID>(a, s);
    default: return launch<BM, BN, -1>(a, s);
  }
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

}  // namespace

// x: int8 [B][H][W][C] NHWC contiguous; w: int8 [N][K] rows, K = KH*KW*C in
// (dy, dx, ci) order; vecs: NVEC f32 [N] pointers (post, bias, inv, shift, rs,
// f; null where unused); res, out: [B*Ho*Wo][N] rows (int8, bf16 or f32 as
// the flags say; x, w, res and out 16-byte aligned); dims: B, H, W, C, Ho,
// Wo, N, KH, KW, stride, pad_t, pad_l, flags, and the tile (BM, BN): (128,
// 32), (128, 64), (256, 64) or (128, 128). Returns cudaErrorInvalidValue for
// operands the kernel cannot run.
extern "C" int int8_conv(const void* x, const void* w, const float* const* vecs,
                         const void* res, void* out, const int* dims, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  Args a;
  const int B = dims[0], KH = dims[7], bm = dims[13], bn = dims[14];
  a.H = dims[1];
  a.W = dims[2];
  a.C = dims[3];
  a.Ho = dims[4];
  a.Wo = dims[5];
  a.N = dims[6];
  a.KW = dims[8];
  a.stride = dims[9];
  a.pad_t = dims[10];
  a.pad_l = dims[11];
  a.flags = dims[12];
  if (B <= 0 || a.H <= 0 || a.W <= 0 || a.Ho <= 0 || a.Wo <= 0 || a.N <= 0 || KH <= 0 ||
      a.KW <= 0 || a.stride <= 0 || a.C <= 0 || a.C % 16 || a.N % 2)
    return bad;
  const long long K = (long long)KH * a.KW * a.C, M = (long long)B * a.Ho * a.Wo;
  if (K > (1 << 24) || M > 0x7fffffff || (long long)a.H * a.W > 0x7fffffff) return bad;
  a.K = (int)K;
  a.M = (int)M;
  a.x = (const int8_t*)x;
  a.w = (const int8_t*)w;
  a.res = res;
  a.out = out;
  for (int i = 0; i < NVEC; ++i) a.vec[i] = vecs[i];
  const int f = a.flags;
  const bool res_float = f & F_RES_FLOAT, res_int8 = f & F_RES_INT8;
  if (!x || !w || !out || !aligned(x, 16) || !aligned(w, 16) || !aligned(out, 16) ||
      !a.vec[0] || !a.vec[1] || ((f & F_BN) && (!a.vec[2] || !a.vec[3])) ||
      (res_float && res_int8) || ((res_float || res_int8) && (!res || !aligned(res, 16))) ||
      (res_int8 && !a.vec[4]) || ((f & F_OUT_INT8) && !a.vec[5]) || f & ~63)
    return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 128 && bn == 32)  // the RPN's head (N = 18)
    return a.flags == 0 ? launch<128, 32, 0>(a, s) : launch<128, 32, -1>(a, s);
  if (bm == 128 && bn == 64) return dispatch<128, 64>(a, s);
  if (bm == 256 && bn == 64) return dispatch<256, 64>(a, s);
  if (bm == 128 && bn == 128) return dispatch<128, 128>(a, s);
  return bad;
}
