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
// What bounds it on the H100: operations, but only those of pairs that can
// overlap. At COCO scale (A = 261,888 anchors, G = 100) a dense loop is 26.2M
// IoU tests an image, and most give 0: consecutive anchors (the order is y,
// x, ratio within a level) cover a narrow strip of the image. Design: a
// block owns a tile of THREADS consecutive anchors of one image, one thread
// an anchor. It reduces the tile's bounding box (min y1, min x1, max y2, max
// x2) and compacts, in ascending g order, the valid GTs that can overlap it
// into a list in shared memory (a ballot and a prefix count a warp, a prefix
// over the warps). A GT with gt.y2 <= tile.y1, gt.y1 >= tile.y2, or the same
// in x, has inter == 0 with every anchor of the tile, so IoU 0; only
// comparisons that hold cull, so a NaN coordinate keeps its GT, and a tile
// holding a NaN anchor coordinate (fmaxf/fminf would drop it from the box)
// culls nothing. Each thread walks the list with best = 0, best_g = 0 and a
// strict `>`, which is the dense loop's answer: every culled IoU is 0.
//
// The per-GT reduction packs (iou bits << 32) | (0xFFFFFFFF - anchor) into
// 64 bits: IoU >= 0, so its bits order as unsigned integers, and the larger
// key is the larger IoU, then the lower anchor. A warp finds its key with one
// max-reduction of the IoU bits and a ballot of the lanes that hold it (the
// lowest such lane holds the lowest anchor), a block combines its warps with
// a shared-memory atomicMax, and one global atomicMax per (block, listed GT)
// with a nonzero best merges the blocks. One launch a call: the
// keys live in a scratch the wrapper keeps per (device, stream, B, G), at IoU
// 0, anchor 0 (the answer for a GT no anchor overlaps) between calls; the
// last block to finish (a counter in the scratch) unpacks every key into
// gt_max / gt_argmax, puts it back to that value, and zeroes the counter.
//
// Exactness: the IoU uses explicitly rounded operations (and --fmad=false) in
// the operation order of objectdetection_torch/geometry.py `iou_matrix`, so
// every IoU is bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // anchors a tile
constexpr int WARPS = THREADS / 32;
constexpr unsigned long long EMPTY_KEY = 0xFFFFFFFFull;  // IoU 0, anchor 0

__device__ __forceinline__ float box_area(float y1, float x1, float y2, float x2) {
  return __fmul_rn(fmaxf(__fsub_rn(y2, y1), 0.0f), fmaxf(__fsub_rn(x2, x1), 0.0f));
}

// grid (ceil(A / THREADS), B), tiles in reverse order; dynamic shared memory: G float4 boxes, G
// uint64 keys, G areas, G GT indices (the list, in ascending g)
__global__ void __launch_bounds__(THREADS)
match_kernel(const float4* __restrict__ anchors, const float4* __restrict__ gt,
             const uint8_t* __restrict__ valid, int num_anchors, int num_gt,
             float* __restrict__ anchor_max, int* __restrict__ anchor_argmax,
             float* __restrict__ gt_max, int* __restrict__ gt_argmax,
             unsigned long long* __restrict__ gt_keys, unsigned int* __restrict__ done) {
  extern __shared__ float4 smem[];
  float4* s_gt = smem;
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(s_gt + num_gt);
  float* s_area = reinterpret_cast<float*>(s_key + num_gt);
  int* s_idx = reinterpret_cast<int*>(s_area + num_gt);
  __shared__ float4 s_box[WARPS];  // the warps' boxes: min y1, min x1, max y2, max x2
  __shared__ int s_count[WARPS];
  __shared__ bool s_last;

  const int img = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // the last tiles first: the coarse levels' tiles span the image and have
  // the longest lists
  const int a = (gridDim.x - 1 - blockIdx.x) * THREADS + t;
  const bool live = a < num_anchors;
  float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) box = anchors[a];
  // the first GT of this thread, loaded before the reductions that need
  // nothing of it
  float4 first_gt = make_float4(0.f, 0.f, 0.f, 0.f);
  bool first_valid = false;
  if (t < num_gt) {
    first_gt = gt[(size_t)img * num_gt + t];
    first_valid = valid[(size_t)img * num_gt + t] != 0;
  }

  // the tile's bounding box; a dead thread adds nothing to it
  float4 tb = live ? box : make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
  for (int off = 16; off > 0; off >>= 1) {
    tb.x = fminf(tb.x, __shfl_xor_sync(0xFFFFFFFFu, tb.x, off));
    tb.y = fminf(tb.y, __shfl_xor_sync(0xFFFFFFFFu, tb.y, off));
    tb.z = fmaxf(tb.z, __shfl_xor_sync(0xFFFFFFFFu, tb.z, off));
    tb.w = fmaxf(tb.w, __shfl_xor_sync(0xFFFFFFFFu, tb.w, off));
  }
  if (lane == 0) s_box[warp] = tb;
  const bool nan_anchor =
      live && (isnan(box.x) || isnan(box.y) || isnan(box.z) || isnan(box.w));
  const bool cull = !__syncthreads_or(nan_anchor);  // also publishes s_box
  tb = s_box[0];
  for (int w = 1; w < WARPS; ++w) {
    const float4 o = s_box[w];
    tb = make_float4(fminf(tb.x, o.x), fminf(tb.y, o.y), fmaxf(tb.z, o.z), fmaxf(tb.w, o.w));
  }

  // the list: valid GTs that can overlap the tile, in ascending g
  int listed = 0;
  for (int g0 = 0; g0 < num_gt; g0 += THREADS) {
    const int g = g0 + t;
    float4 b = first_gt;
    bool keep = first_valid;
    if (g0 > 0) {
      keep = g < num_gt && valid[(size_t)img * num_gt + g];
      if (keep) b = gt[(size_t)img * num_gt + g];
    }
    if (keep) keep = !(cull && (b.z <= tb.x || b.x >= tb.z || b.w <= tb.y || b.y >= tb.w));
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int pos = listed + __popc(ballot & ((1u << lane) - 1u)), total = listed;
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_count[w];
      if (w < warp) pos += c;
      total += c;
    }
    if (keep) {
      s_gt[pos] = b;
      s_key[pos] = 0ull;
      s_area[pos] = box_area(b.x, b.y, b.z, b.w);
      s_idx[pos] = g;
    }
    listed = total;
    __syncthreads();  // the list is complete; s_count is reused
  }

  const float area_a = box_area(box.x, box.y, box.z, box.w);
  const unsigned int anchor_tag = 0xFFFFFFFFu - (unsigned int)a;
  float best = 0.0f;
  int best_g = 0;
  for (int j = 0; j < listed; ++j) {
    const float4 b = s_gt[j];
    float iou = 0.0f;
    if (live) {
      const float iy1 = fmaxf(box.x, b.x), ix1 = fmaxf(box.y, b.y);
      const float iy2 = fminf(box.z, b.z), ix2 = fminf(box.w, b.w);
      const float inter =
          __fmul_rn(fmaxf(__fsub_rn(iy2, iy1), 0.0f), fmaxf(__fsub_rn(ix2, ix1), 0.0f));
      const float uni = __fsub_rn(__fadd_rn(area_a, s_area[j]), inter);
      iou = (inter > 0.0f && uni > 0.0f) ? __fdiv_rn(inter, uni) : 0.0f;
    }
    if (iou > best) {  // strict: the first maximum wins
      best = iou;
      best_g = s_idx[j];
    }
    // the warp's key: its largest IoU (as bits: IoU >= 0), then its lowest
    // lane, which holds the lowest anchor; all 32 lanes run every iteration
    const unsigned bits = __float_as_uint(iou);
    const unsigned top = __reduce_max_sync(0xFFFFFFFFu, bits);
    if (top != 0u) {
      const unsigned first = __ffs(__ballot_sync(0xFFFFFFFFu, bits == top)) - 1;
      if (lane == first) atomicMax(&s_key[j], ((unsigned long long)top << 32) | anchor_tag);
    }
  }
  if (live) {
    anchor_max[(size_t)img * num_anchors + a] = best;
    anchor_argmax[(size_t)img * num_anchors + a] = best_g;
  }
  __syncthreads();
  for (int j = t; j < listed; j += THREADS) {
    if (s_key[j] != 0ull) atomicMax(&gt_keys[(size_t)img * num_gt + s_idx[j]], s_key[j]);
  }

  // the last block to finish unpacks the keys and leaves the scratch clean
  __threadfence();
  __syncthreads();
  if (t == 0) {
    const unsigned int blocks = gridDim.x * gridDim.y;
    s_last = atomicAdd(done, 1u) == blocks - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int n = gridDim.y * num_gt;
  for (int i = t; i < n; i += THREADS) {
    const unsigned long long k = atomicExch(&gt_keys[i], EMPTY_KEY);
    gt_max[i] = __uint_as_float((unsigned int)(k >> 32));
    gt_argmax[i] = (int)(0xFFFFFFFFu - (unsigned int)(k & 0xFFFFFFFFull));
  }
  if (t == 0) *done = 0u;
}

}  // namespace

// anchors [A, 4] f32; gt [batch, G, 4] f32; valid [batch, G] uint8;
// outputs anchor_max [batch, A] f32, anchor_argmax [batch, A] int32,
// gt_max [batch, G] f32, gt_argmax [batch, G] int32; keys: [batch, G] uint64
// scratch holding 0xFFFFFFFF (IoU 0, anchor 0) and done: one uint32 holding
// 0, both left so by the call. Returns a cudaError_t.
extern "C" int anchor_match(const void* anchors, const void* gt, const void* valid, int batch,
                            int num_anchors, int num_gt, void* anchor_max, void* anchor_argmax,
                            void* gt_max, void* gt_argmax, void* keys, void* done,
                            void* stream) {
  if (batch <= 0 || num_anchors <= 0) return 0;
  if (num_gt <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)num_gt * (sizeof(float4) + sizeof(unsigned long long) +
                                         sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((num_anchors + THREADS - 1) / THREADS, batch);
  match_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float4*)anchors, (const float4*)gt, (const uint8_t*)valid, num_anchors, num_gt,
      (float*)anchor_max, (int*)anchor_argmax, (float*)gt_max, (int*)gt_argmax,
      (unsigned long long*)keys, (unsigned int*)done);
  return (int)cudaGetLastError();
}
