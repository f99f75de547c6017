// Anchor <-> ground-truth IoU matching: max and argmax both ways, batched
// over images.
//
// Replaces the Pallas TPU kernel objectdetection_tpu/ops/anchor_match.py
// `_match_kernel` (entered through `anchor_match_pallas`). The target is the
// exact semantics of `anchor_match_xla`, batched: for anchors [A, 4] shared
// by the batch and GT boxes [B, G, 4] with validity [B, G],
//   iou[b, a, g] = IoU(anchor a, gt[b, g]), 0 where gt[b, g] is invalid;
//   anchor_max/argmax[b, a] = max/argmax over g;
//   gt_max/argmax[b, g]     = max/argmax over a;
// ties go to the lowest index, as jnp.argmax within a Pallas tile and the
// strict `>` across tiles give together. A GT that is invalid, or has IoU 0
// with every anchor, comes out as (0, 0).
//
// What bounds it on the H100: operations. At COCO scale (A = 261,888 anchors,
// G = 100) one image is 26.2M IoU tests of ~19 f32 ops and reads only 4.2 MB
// of anchors. Design: one thread per anchor loops over the image's G boxes,
// held in shared memory with their areas, and keeps the per-anchor best in
// registers. The [A, G] matrix is never built. The per-GT reduction packs
// (iou bits << 32) | (0xFFFFFFFF - anchor) into 64 bits: IoU >= 0, so its
// bits order as unsigned integers, and the larger key is the larger IoU, then
// the lower anchor. A warp reduces a key with shuffles (skipped when no lane
// has a nonzero IoU, the common case), a block combines its warps with a
// shared-memory atomicMax, and one global atomicMax per (block, GT) with a
// nonzero best merges the blocks: no barrier inside the loop over GTs. The
// global keys start at IoU 0, anchor 0, which is the answer for a GT no
// anchor overlaps.
//
// Exactness: the IoU uses explicitly rounded operations (and --fmad=false) in
// the operation order of objectdetection_torch/geometry.py `iou_matrix`, so
// every IoU is bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned long long EMPTY_KEY = 0xFFFFFFFFull;  // IoU 0, anchor 0

__device__ __forceinline__ float box_area(float y1, float x1, float y2, float x2) {
  return __fmul_rn(fmaxf(__fsub_rn(y2, y1), 0.0f), fmaxf(__fsub_rn(x2, x1), 0.0f));
}

__global__ void init_keys(unsigned long long* keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = EMPTY_KEY;
}

// grid (ceil(A / THREADS), B); dynamic shared memory: G float4 boxes, G
// uint64 keys, G areas, G valid flags
__global__ void __launch_bounds__(THREADS)
match_kernel(const float4* __restrict__ anchors, const float4* __restrict__ gt,
             const uint8_t* __restrict__ valid, int num_anchors, int num_gt,
             float* __restrict__ anchor_max, int* __restrict__ anchor_argmax,
             unsigned long long* __restrict__ gt_keys) {
  extern __shared__ float4 smem[];
  float4* s_gt = smem;
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(s_gt + num_gt);
  float* s_area = reinterpret_cast<float*>(s_key + num_gt);
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_area + num_gt);

  const int img = blockIdx.y;
  const int t = threadIdx.x;
  for (int g = t; g < num_gt; g += THREADS) {
    const float4 b = gt[(size_t)img * num_gt + g];
    s_gt[g] = b;
    s_key[g] = 0ull;
    s_area[g] = box_area(b.x, b.y, b.z, b.w);
    s_valid[g] = valid[(size_t)img * num_gt + g];
  }
  __syncthreads();

  const int a = blockIdx.x * THREADS + t;
  const bool live = a < num_anchors;
  float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) box = anchors[a];
  const float area_a = box_area(box.x, box.y, box.z, box.w);
  const unsigned int anchor_tag = 0xFFFFFFFFu - (unsigned int)a;

  float best = 0.0f;
  int best_g = 0;
  for (int g = 0; g < num_gt; ++g) {
    const float4 b = s_gt[g];
    float iou = 0.0f;
    if (live && s_valid[g]) {
      const float iy1 = fmaxf(box.x, b.x), ix1 = fmaxf(box.y, b.y);
      const float iy2 = fminf(box.z, b.z), ix2 = fminf(box.w, b.w);
      const float inter =
          __fmul_rn(fmaxf(__fsub_rn(iy2, iy1), 0.0f), fmaxf(__fsub_rn(ix2, ix1), 0.0f));
      const float uni = __fsub_rn(__fadd_rn(area_a, s_area[g]), inter);
      // most pairs do not overlap: 0 / union is 0, so skip the division
      iou = (inter > 0.0f && uni > 0.0f) ? __fdiv_rn(inter, uni) : 0.0f;
    }
    if (g == 0 || iou > best) {  // strict: the first maximum wins
      best = iou;
      best_g = g;
    }
    unsigned long long key =
        iou > 0.0f ? ((unsigned long long)__float_as_uint(iou) << 32) | anchor_tag : 0ull;
    // all 32 lanes run every iteration, so the warp-wide vote and shuffles
    // are safe; most (warp, GT) pairs have no overlap and skip the reduction
    if (__any_sync(0xFFFFFFFFu, key != 0ull)) {
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, key, off);
        key = other > key ? other : key;
      }
      if ((t & 31) == 0) atomicMax(&s_key[g], key);
    }
  }
  if (live) {
    anchor_max[(size_t)img * num_anchors + a] = best;
    anchor_argmax[(size_t)img * num_anchors + a] = best_g;
  }
  __syncthreads();
  for (int g = t; g < num_gt; g += THREADS) {
    if (s_key[g] != 0ull) atomicMax(&gt_keys[(size_t)img * num_gt + g], s_key[g]);
  }
}

__global__ void unpack_keys(const unsigned long long* keys, int n, float* gt_max,
                            int* gt_argmax) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long k = keys[i];
    gt_max[i] = __uint_as_float((unsigned int)(k >> 32));
    gt_argmax[i] = (int)(0xFFFFFFFFu - (unsigned int)(k & 0xFFFFFFFFull));
  }
}

}  // namespace

// anchors [A, 4] f32; gt [batch, G, 4] f32; valid [batch, G] uint8;
// outputs anchor_max [batch, A] f32, anchor_argmax [batch, A] int32,
// gt_max [batch, G] f32, gt_argmax [batch, G] int32; keys: [batch, G] uint64
// scratch. Returns a cudaError_t.
extern "C" int anchor_match(const void* anchors, const void* gt, const void* valid, int batch,
                            int num_anchors, int num_gt, void* anchor_max, void* anchor_argmax,
                            void* gt_max, void* gt_argmax, void* keys, void* stream) {
  if (batch <= 0 || num_anchors <= 0) return 0;
  if (num_gt <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = batch * num_gt;
  const size_t smem = (size_t)num_gt * (sizeof(float4) + sizeof(unsigned long long) +
                                         sizeof(float) + sizeof(uint8_t));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  init_keys<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>((unsigned long long*)keys, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_anchors + THREADS - 1) / THREADS, batch);
  match_kernel<<<grid, THREADS, smem, s>>>(
      (const float4*)anchors, (const float4*)gt, (const uint8_t*)valid, num_anchors, num_gt,
      (float*)anchor_max, (int*)anchor_argmax, (unsigned long long*)keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  unpack_keys<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (const unsigned long long*)keys, n, (float*)gt_max, (int*)gt_argmax);
  return (int)cudaGetLastError();
}
