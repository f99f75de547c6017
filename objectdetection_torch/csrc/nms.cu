// Greedy non-max suppression over score-sorted boxes, one block per image.
//
// Replaces the Pallas TPU kernel objectdetection_tpu/ops/nms_pallas.py
// `_nms_kernel` (entered through `nms_suppress_pallas`). Same contract: boxes
// [B, N, 4] f32 sorted by descending score (invalid rows already zeroed),
// class ids [B, N] i32; a row dies if its IoU with an earlier surviving row
// of the same class exceeds the threshold; dead rows come out as zeros. Rows
// are resolved in tiles of TILE = 256, and the pass stops after the tile in
// which the count of nonzero survivors reaches `budget`: rows after it come
// out as zeros, exactly as in the Pallas kernel.
//
// What bounds it on the H100: latency, not bytes or FLOPs. The input is at
// most 6144 rows (~100 KB) per image and greedy NMS is a serial recurrence.
// Design: the survivors so far live in a compacted shared-memory table
// (capacity budget + TILE), so each tile row is tested in parallel (one thread
// per row) against survivors only, never against all earlier rows; the
// within-tile pairwise tests run in parallel into a 256x256 bit matrix; the
// serial greedy pass over the tile is then one thread doing 8 word ANDs per
// row. The budget stop means a 6000-row proposal set usually touches a few
// tiles. The batch is the grid: one block per image.
//
// Exactness: the IoU is inter / union with the union > 0 guard, in the
// operation order of nms_pallas.py `_iou_rows`, with every operation
// explicitly rounded (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, and the
// file is built with --fmad=false). A single contracted FMA moves an IoU by
// an ulp, which is enough to flip a near-threshold comparison.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;
constexpr int WORDS = TILE / 32;

__device__ __forceinline__ float iou_rn(float4 a, float4 b) {
  // a, b: (y1, x1, y2, x2), corners canonicalized by the caller
  float iy = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  float ix = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  float inter = __fmul_rn(iy, ix);
  float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void __launch_bounds__(TILE)
nms_kernel(const float4* __restrict__ boxes, const int* __restrict__ cls,
           float4* __restrict__ out, int n, float thr, int budget, int cap) {
  extern __shared__ float4 smem[];
  float4* sup_box = smem;                                // [cap]
  int* sup_cls = reinterpret_cast<int*>(smem + cap);     // [cap]
  __shared__ uint32_t kill[TILE][WORDS];  // kill[i] bit j: earlier row j kills i
  __shared__ float4 tile_box[TILE];
  __shared__ int tile_cls[TILE];
  __shared__ uint8_t cross_ok[TILE];
  __shared__ uint8_t alive[TILE];
  __shared__ int s_count;

  const int img = blockIdx.x;
  const int t = threadIdx.x;
  boxes += (size_t)img * n;
  cls += (size_t)img * n;
  out += (size_t)img * n;

  for (int i = t; i < n; i += TILE) out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t == 0) s_count = 0;
  __syncthreads();

  for (int start = 0; start < n; start += TILE) {
    const int count = s_count;
    if (count >= budget) break;  // uniform: every thread read s_count after a sync
    const int i = start + t;
    const bool in = i < n;
    const float4 bx = in ? boxes[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    const int c = in ? cls[i] : -1;
    tile_box[t] = bx;
    tile_cls[t] = c;

    // 1. cross-tile: killed by any same-class survivor of earlier tiles
    bool ok = true;
    for (int s = 0; s < count; ++s) {
      if (sup_cls[s] == c && iou_rn(bx, sup_box[s]) > thr) {
        ok = false;
        break;
      }
    }
    cross_ok[t] = ok;
    __syncthreads();

    // 2. within-tile pairwise tests, one row per thread
    for (int w = 0; w < WORDS; ++w) {
      uint32_t bits = 0;
      const int j0 = w * 32;
      if (j0 < t) {
        const int jend = min(j0 + 32, t);
        for (int j = j0; j < jend; ++j) {
          if (tile_cls[j] == c && iou_rn(tile_box[j], bx) > thr) bits |= 1u << (j - j0);
        }
      }
      kill[t][w] = bits;
    }
    __syncthreads();

    // 3. serial greedy resolution of the tile + append survivors
    if (t == 0) {
      uint32_t live_mask[WORDS];
#pragma unroll
      for (int w = 0; w < WORDS; ++w) live_mask[w] = 0u;
      int cnt = count;
      const int rows = min(TILE, n - start);
      for (int r = 0; r < rows; ++r) {
        bool a = cross_ok[r];
        if (a) {
#pragma unroll
          for (int w = 0; w < WORDS; ++w) {
            if (kill[r][w] & live_mask[w]) a = false;
          }
        }
        alive[r] = a;
        if (a) {
          live_mask[r >> 5] |= 1u << (r & 31);
          const float4 v = tile_box[r];
          if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) {
            sup_box[cnt] = v;
            sup_cls[cnt] = tile_cls[r];
            ++cnt;
          }
        }
      }
      s_count = cnt;
    }
    __syncthreads();
    if (in && alive[t]) out[i] = bx;
    __syncthreads();
  }
}

}  // namespace

extern "C" int nms_suppress(const void* boxes, const void* cls, void* out, int batch,
                            int n, float thr, int budget, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int b = budget < n ? budget : n;
  const int cap = b + TILE;
  const size_t smem = (size_t)cap * (sizeof(float4) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_kernel<<<batch, TILE, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const int*)cls, (float4*)out, n, thr, b, cap);
  return (int)cudaGetLastError();
}
