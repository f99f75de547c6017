// Greedy non-max suppression over score-sorted boxes: a pairwise kill-bit
// matrix across the card, then a bit-vector greedy sweep per image.
//
// Replaces the Pallas TPU kernel objectdetection_tpu/ops/nms_pallas.py:70
// `_nms_kernel` (entered through `nms_suppress_pallas`). Same contract: boxes
// [B, N, 4] f32 sorted by descending score (invalid rows already zeroed),
// class ids [B, N] i32; a row dies if its IoU with an earlier surviving row
// of the same class exceeds the threshold; dead rows come out as zeros. Rows
// are resolved in tiles of TILE = 256, and the pass stops after the tile in
// which the count of nonzero survivors reaches `budget`: rows after it come
// out as zeros, exactly as in the Pallas kernel.
//
// What bounds it on the H100: neither bytes nor FLOPs. The IoU work is a few
// tens of MFLOP (~36 M tests at N = 6000, B = 2: ~0.01 ms at the f32 rate)
// and the box table ~100 KB per image. The floor is the greedy recurrence:
// whether row i survives depends on every earlier survivor, one row after
// another.
//
// Design: the IoU tests go across the card, and only bit operations stay
// serial.
// 1. `nms_mask_kernel`: rows fall into 64-row chunks; one block of 64
//    threads per (image, row chunk i, column chunk j >= i), the upper
//    triangle (4,465 blocks per image at N = 6000). The block stages the
//    column chunk's boxes and classes in shared memory; thread r writes one
//    64-bit word, whose bit k is set when row 64j+k comes after row 64i+r,
//    has its class and has IoU > thr. The words go to a scratch
//    [B, N, ceil(N/64)] that the caller allocates; only the upper triangle
//    is written and read (4.5 MB per image at N = 6000, held in the 50 MB L2).
// 2. `nms_sweep_kernel`: one block per image walks the chunks in order with a
//    `removed` bit vector of ceil(N/64) words in shared memory. Warp 0
//    resolves a chunk in registers: row r is kept when its `removed` bit is
//    clear, and a kept row ORs its diagonal word into the chunk's bits (one
//    step per kept row that kills within the chunk; no division). Then the
//    block ORs the later words of every kept row into `removed`, across words
//    and rows at once, 16 independent loads in flight per thread (the words
//    come from L2), while warps 0 and 1 write the chunk's rows out and load
//    the next chunk's diagonal words and boxes.
//
// All-zero rows: an all-zero row has IoU 0 with every box, so it never kills
// for thr >= 0. For thr < 0 the Pallas kernel lets a kept all-zero row kill
// the later rows of its own 256-row tile (it joins the tile's live mask) but
// never appends it to the survivor table, so it kills nothing in later tiles.
// Here a kept all-zero row ORs its bits only into words of its own tile.
//
// Exactness: the IoU is inter / union with the union > 0 guard, in the
// operation order of nms_pallas.py `_iou_rows` with the later row as `a`,
// and every operation explicitly rounded (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn; the file is built with --fmad=false). A single contracted FMA
// moves an IoU by an ulp, which is enough to flip a near-threshold
// comparison. The division is skipped only where thr * union decides the
// comparison with a margin of 2^-16 (`iou_above`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int CHUNK = 64;            // rows per bit-matrix word
constexpr int MAX_WORDS = 256;       // words per row: N <= 16384
constexpr int SWEEP_THREADS = 512;
constexpr int OR_BATCH = 16;         // loads in flight per sweep thread

// Whether IoU(a, b) > thr, with the IoU rounded as the plain version rounds
// it. Where thr * union settles the comparison by a margin of 2^-16 (far
// beyond the few roundings of 2^-24 each on either side), the division is
// skipped; near the threshold, or outside normal ranges, it is done.
__device__ __forceinline__ bool iou_above(float4 a, float4 b, float thr) {
  // a, b: (y1, x1, y2, x2), corners canonicalized by the caller
  float iy = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  float ix = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  float inter = __fmul_rn(iy, ix);
  float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (!(uni > 0.0f)) return 0.0f > thr;  // the plain version's IoU is 0 here
  if (thr >= 0x1p-100f) {
    const float p = __fmul_rn(thr, uni);
    if (p >= 0x1p-100f && p <= 0x1p100f) {
      if (inter <= __fmul_rn(p, 1.0f - 0x1p-16f)) return false;  // IoU < thr (1 - 2^-17)
      if (inter >= __fmul_rn(p, 1.0f + 0x1p-16f)) return true;   // IoU > thr (1 + 2^-17)
    }
  }
  return __fdiv_rn(inter, uni) > thr;
}

__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
}

// first linear block index of row chunk i in the upper triangle of nw chunks
__device__ __forceinline__ int tri_start(int i, int nw) { return i * (2 * nw - i + 1) / 2; }

__global__ void __launch_bounds__(CHUNK)
nms_mask_kernel(const float4* __restrict__ boxes, const int* __restrict__ cls,
                u64* __restrict__ mask, int n, int nw, float thr) {
  __shared__ float4 col_box[CHUNK];
  __shared__ int col_cls[CHUNK];

  // blockIdx.x enumerates (i, j >= i) row by row
  const int lin = blockIdx.x;
  const double m = 2.0 * nw + 1.0;
  int i = (int)((m - sqrt(m * m - 8.0 * lin)) * 0.5);
  i = max(0, min(i, nw - 1));
  while (i > 0 && tri_start(i, nw) > lin) --i;
  while (i + 1 < nw && tri_start(i + 1, nw) <= lin) ++i;
  const int j = i + (lin - tri_start(i, nw));

  const int img = blockIdx.y;
  const int t = threadIdx.x;
  boxes += (size_t)img * n;
  cls += (size_t)img * n;
  mask += (size_t)img * n * nw;

  const int col = j * CHUNK + t;
  col_box[t] = col < n ? boxes[col] : make_float4(0.f, 0.f, 0.f, 0.f);
  col_cls[t] = col < n ? cls[col] : 0;
  __syncthreads();

  const int row = i * CHUNK + t;
  if (row >= n) return;
  const float4 b = boxes[row];
  const int c = cls[row];
  const int kend = min(CHUNK, n - j * CHUNK);
  u64 bits = 0ull;
  for (int k = i == j ? t + 1 : 0; k < kend; ++k) {
    if (col_cls[k] == c && iou_above(col_box[k], b, thr)) bits |= 1ull << k;
  }
  mask[(size_t)row * nw + j] = bits;
}

// Thread t < CHUNK of the sweep stores row t's diagonal word of the staged
// chunk; warps 0 and 1 publish which of the chunk's rows are nonzero and which
// kill within the chunk, 32 rows each. Returns the row's box.
__device__ __forceinline__ float4 publish(float4 bx, u64 d, u64* diag, unsigned* nz_half,
                                          unsigned* kill_half) {
  const int t = threadIdx.x;
  diag[t] = d;
  const unsigned nz = __ballot_sync(0xffffffffu, nonzero(bx));
  const unsigned kills = __ballot_sync(0xffffffffu, d != 0ull);
  if ((t & 31) == 0) {
    nz_half[t >> 5] = nz;
    kill_half[t >> 5] = kills;
  }
  return bx;
}

__global__ void __launch_bounds__(SWEEP_THREADS)
nms_sweep_kernel(const float4* __restrict__ boxes, const u64* __restrict__ mask,
                 float4* __restrict__ out, int n, int nw, int budget) {
  __shared__ u64 removed[MAX_WORDS];
  __shared__ u64 diag[CHUNK];             // the staged chunk's diagonal words
  __shared__ unsigned nz_half[2];         // its nonzero rows, one word per warp
  __shared__ unsigned kill_half[2];       // its rows with a nonzero diagonal word
  __shared__ int kept_rows[CHUNK];
  __shared__ u64 s_keep, s_live;          // kept rows; kept nonzero rows
  __shared__ int s_kept, s_stop;

  const int img = blockIdx.x;
  const int t = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  boxes += (size_t)img * n;
  out += (size_t)img * n;
  mask += (size_t)img * n * nw;
  for (int w = t; w < nw; w += SWEEP_THREADS) removed[w] = 0ull;

  int done = 0;   // chunks resolved (uniform)
  int count = 0;  // nonzero survivors (thread 0)
  float4 bx = zero;  // thread t < CHUNK: row t of the staged chunk
  if (budget > 0) {
    if (t < CHUNK) {  // stage chunk 0
      const bool in = t < n;
      bx = publish(in ? boxes[t] : zero, in ? mask[(size_t)t * nw] : 0ull, diag, nz_half,
                   kill_half);
    }
    __syncthreads();
    for (int c = 0; c < nw; ++c) {
      // 1. warp 0 resolves the chunk, every lane on the same values
      if (t < 32) {
        const int rows = min(CHUNK, n - c * CHUNK);
        const u64 valid = rows == CHUNK ? ~0ull : (1ull << rows) - 1ull;
        const u64 nz = (u64)nz_half[0] | ((u64)nz_half[1] << 32);
        // only rows that kill within the chunk change it: step over those,
        // in order; every other row not removed is kept as it is
        const u64 killers = ((u64)kill_half[0] | ((u64)kill_half[1] << 32)) & valid;
        u64 rem = removed[c] | ~valid;
        u64 cand = ~rem & killers;
        while (cand) {
          const int r = __ffsll((long long)cand) - 1;
          rem |= diag[r];
          cand = ~rem & killers & ~((2ull << r) - 1ull);  // r = 63: 2 << 63 wraps to 0
        }
        const u64 keep = ~rem;
        for (int r = t; r < CHUNK; r += 32) {  // list the kept rows in order
          if ((keep >> r) & 1ull) kept_rows[__popcll(keep & ((1ull << r) - 1ull))] = r;
        }
        if (t == 0) {
          count += __popcll(keep & nz);
          s_keep = keep;
          s_live = keep & nz;
          s_kept = __popcll(keep);
          // the stop rule, checked at the end of every 256-row tile
          s_stop = (c & 3) == 3 && count >= budget;
        }
      }
      __syncthreads();
      const u64 keep = s_keep, live = s_live;
      const int k = s_kept;
      const bool stop = s_stop;
      // warps 0 and 1 write the chunk's rows out and start loading the next
      // chunk, so those loads overlap step 2's
      const bool staging = !stop && c + 1 < nw && t < CHUNK;
      float4 next_bx = zero;
      u64 next_diag = 0ull;
      if (t < CHUNK) {
        const int row = c * CHUNK + t;
        if (row < n) out[row] = (keep >> t) & 1ull ? bx : zero;
        if (staging && row + CHUNK < n) {
          next_bx = boxes[row + CHUNK];
          next_diag = mask[(size_t)(row + CHUNK) * nw + c + 1];
        }
      }

      // 2. the kept rows' later words into `removed`: thread (g, w) ORs the
      //    words w of the kept rows g, g + groups, ..., OR_BATCH loads at a time
      const int rest = nw - c - 1;
      if (!stop && rest > 0 && k > 0) {
        const int span = (rest + 31) & ~31;
        const int groups = SWEEP_THREADS / span;  // >= 2: rest < MAX_WORDS
        const int g = t / span;
        const int w = c + 1 + (t - g * span);
        if (g < groups && w < nw) {
          const int tile_end = c | 3;  // the last word of this chunk's tile
          const u64* src = mask + (size_t)c * CHUNK * nw + w;
          u64 acc = 0ull;
          for (int q0 = g; q0 < k; q0 += OR_BATCH * groups) {
            u64 v[OR_BATCH];
#pragma unroll
            for (int u = 0; u < OR_BATCH; ++u) {
              const int q = q0 + u * groups;
              const int r = q < k ? kept_rows[q] : 0;
              // row 64c + r is a row of this chunk, so the load is in bounds
              // even when it is not used
              const u64 x = src[(size_t)r * nw];
              v[u] = q < k && (w <= tile_end || ((live >> r) & 1ull)) ? x : 0ull;
            }
#pragma unroll
            for (int u = 0; u < OR_BATCH; ++u) acc |= v[u];
          }
          if (acc) atomicOr(&removed[w], acc);
        }
      }
      done = c + 1;
      if (stop) break;  // uniform: every thread read s_stop after the sync

      // 3. publish the next chunk (warp 0 read the staged words before the sync)
      if (staging) bx = publish(next_bx, next_diag, diag, nz_half, kill_half);
      __syncthreads();
    }
  }
  // rows after the stop come out as zeros
  for (int row = done * CHUNK + t; row < n; row += SWEEP_THREADS) out[row] = zero;
}

}  // namespace

// boxes [B, N, 4] f32, cls [B, N] i32, out [B, N, 4] f32, mask scratch
// [B, N, ceil(N / 64)] 64-bit words. Returns a CUDA error code (0 on success).
extern "C" int nms_suppress(const void* boxes, const void* cls, void* out, void* mask,
                            int batch, int n, float thr, int budget, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int nw = (n + CHUNK - 1) / CHUNK;
  // the sweep's shared row of words, and the grid's second dimension
  if (nw > MAX_WORDS || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)(nw * (nw + 1) / 2), (unsigned)batch);
  nms_mask_kernel<<<grid, CHUNK, 0, s>>>((const float4*)boxes, (const int*)cls, (u64*)mask,
                                         n, nw, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_sweep_kernel<<<batch, SWEEP_THREADS, 0, s>>>((const float4*)boxes, (const u64*)mask,
                                                   (float4*)out, n, nw, budget);
  return (int)cudaGetLastError();
}
