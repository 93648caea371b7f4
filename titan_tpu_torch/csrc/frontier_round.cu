// frontier_round: the fused bottom-up chunk round of the direction-
// optimizing BFS, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_frontier_round_kernel` launched by
// `frontier_round` in titan_tpu/ops/pallas_frontier.py. It computes what
// that kernel computes (see titan_tpu_torch/ops/frontier.py for the
// contract and `frontier_round_reference` for the plain version), not
// what it does block by block: the TPU kernel keeps survivor order with
// an SMEM cursor carried across a SEQUENTIAL grid, and CUDA blocks run
// concurrently. So the round is three launches on one stream:
//
//   A. round_test: one thread per candidate. Narrow fetch of the leading
//      `lanes` rows of its dstT column, bitmap test for each of the K
//      jobs (tombstoned slots masked), the 8-lane refetch only when some
//      undecided job still missed, `found` written, a survivor flag kept,
//      and the block's survivor count from __syncthreads_count.
//   B. scan_counts: one block, an exclusive scan over the block counts
//      in tiles of 8192: a coalesced load into shared memory, 8
//      consecutive counts per thread, a warp-shuffle scan, a coalesced
//      store, and a carry from tile to tile; writes the total survivor
//      count `nsur` on the device.
//   C. compact: ballot/popc rank inside each warp, warp offsets from
//      shared memory, block offset from B; scatters pay0/pay1 to their
//      stable slots and fills every slot from nsur on with fill0/fill1.
//
// What bounds it: the dstT reads. dstT is [8, Q] int32, so each fetched
// lane entry of a random column is its own 32-byte sector (a candidate's
// 8 lanes lie Q*4 bytes apart). The frontier bitmaps are n/8 bytes
// (8.4 MB at Graph500 scale 26) and stay in the 50 MB L2. Everything else
// is read or written once, coalesced.
//
// Offsets: dstT offsets (lane*Q + col) and tombstone slots (col*8 + lane)
// are 64-bit: at scale 26 Q is about 282M, so both pass 2^31. Every
// gather is clamped into its array (cols to [0, Q-1], bitmap bytes to
// [0, nb-1], slot bytes to [0, tb-1]), as the plain version clamps them:
// an out-of-range read must never fault the context.
//
// Left for later: decoupled look-back to fold B and C into A, cp.async
// or TMA staging of the candidate arrays, and the [Q, 8] layout (one
// sector per chunk) in place of [8, Q].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // rounds A and C: one candidate per thread
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;  // round B: one block
constexpr int kScanItems = 8;       // counts per thread per tile
constexpr int kScanTile = kScanThreads * kScanItems;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo,
                                           int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// any lane in [l0, l1) of `par` hits bitmap `fb` (tombstoned lanes skipped)
__device__ __forceinline__ bool hit_lanes(const uint8_t* __restrict__ fb,
                                          int64_t nb, const int32_t* par,
                                          int l0, int l1, uint32_t tomb) {
  bool h = false;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    if (l < l0 || l >= l1 || ((tomb >> l) & 1u)) continue;
    const int32_t p = par[l];
    const int64_t byte = clamp64(p >> 3, 0, nb - 1);
    h |= ((__ldg(fb + byte) >> (p & 7)) & 1) != 0;
  }
  return h;
}

__global__ void __launch_bounds__(kThreads)
round_test(const int32_t* __restrict__ cols, const uint8_t* __restrict__ undec,
           const uint8_t* __restrict__ has_more,
           const uint8_t* __restrict__ fbits, const uint8_t* __restrict__ tbits,
           const int32_t* __restrict__ dstT, int64_t C, int K, int64_t Q,
           int64_t nb, int64_t tb, int lanes, uint8_t* __restrict__ found,
           uint8_t* __restrict__ surv, int32_t* __restrict__ counts) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  bool s = false;
  if (j < C) {
    const int64_t col = clamp64(__ldg(cols + j), 0, Q - 1);
    int32_t par[8];
#pragma unroll
    for (int l = 0; l < 8; ++l)
      if (l < lanes) par[l] = __ldg(dstT + (int64_t)l * Q + col);
    uint32_t tomb = 0;
    if (tbits != nullptr) {
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const int64_t slot = col * 8 + l;
        const uint8_t w = __ldg(tbits + clamp64(slot >> 3, 0, tb - 1));
        tomb |= (uint32_t)((w >> (slot & 7)) & 1) << l;
      }
    }
    // narrow round: every job tests the leading lanes
    bool missed = false;
    for (int k = 0; k < K; ++k) {
      const bool u = undec[(int64_t)k * C + j] != 0;
      const bool h = u && hit_lanes(fbits + (int64_t)k * nb, nb, par, 0,
                                    lanes, tomb);
      found[(int64_t)k * C + j] = h;
      missed |= u && !h;
    }
    // wide round: only candidates some undecided job still missed
    if (missed && lanes < 8) {
#pragma unroll
      for (int l = 0; l < 8; ++l)
        if (l >= lanes) par[l] = __ldg(dstT + (int64_t)l * Q + col);
      missed = false;
      for (int k = 0; k < K; ++k) {
        const bool u = undec[(int64_t)k * C + j] != 0;
        if (!u || found[(int64_t)k * C + j]) continue;
        const bool h = hit_lanes(fbits + (int64_t)k * nb, nb, par, lanes, 8,
                                 tomb);
        found[(int64_t)k * C + j] = h;
        missed |= !h;
      }
    }
    s = missed && has_more[j] != 0;
    surv[j] = s;
  }
  const int cnt = __syncthreads_count(s);
  if (threadIdx.x == 0) counts[blockIdx.x] = cnt;
}

// tile index -> shared-memory word, one pad word per 32: the coalesced
// stores (consecutive i) and the per-thread runs (stride kScanItems) are
// both free of bank conflicts
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(kScanThreads)
scan_counts(const int32_t* __restrict__ counts, int64_t nblocks,
            int32_t* __restrict__ offsets, int32_t* __restrict__ nsur) {
  __shared__ int32_t tile[kScanTile + kScanTile / 32];
  __shared__ int32_t warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t carry = 0;  // sum of the counts of the earlier tiles
  for (int64_t t0 = 0; t0 < nblocks; t0 += kScanTile) {
    // coalesced load: thread i reads t0 + i, t0 + i + kScanThreads, ...
#pragma unroll
    for (int r = 0; r < kScanItems; ++r) {
      const int i = r * kScanThreads + threadIdx.x;
      tile[padded(i)] = t0 + i < nblocks ? counts[t0 + i] : 0;
    }
    __syncthreads();
    // each thread owns kScanItems consecutive counts of the tile
    int32_t v[kScanItems];
    int32_t local = 0;
#pragma unroll
    for (int r = 0; r < kScanItems; ++r) {
      v[r] = tile[padded(threadIdx.x * kScanItems + r)];
      local += v[r];
    }
    int32_t x = local;  // inclusive scan inside the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int32_t w = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    int32_t base = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - local;
#pragma unroll
    for (int r = 0; r < kScanItems; ++r) {
      tile[padded(threadIdx.x * kScanItems + r)] = base;
      base += v[r];
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kScanItems; ++r) {  // coalesced store
      const int i = r * kScanThreads + threadIdx.x;
      if (t0 + i < nblocks) offsets[t0 + i] = tile[padded(i)];
    }
    __syncthreads();  // the next tile overwrites tile and warp_sums
  }
  if (threadIdx.x == 0) *nsur = carry;
}

__global__ void __launch_bounds__(kThreads)
compact(const uint8_t* __restrict__ surv, const int32_t* __restrict__ offsets,
        const int32_t* __restrict__ nsur, const int32_t* __restrict__ pay0,
        const int32_t* __restrict__ pay1, int64_t C, int fill0, int fill1,
        int32_t* __restrict__ out0, int32_t* __restrict__ out1) {
  __shared__ int32_t warp_counts[kWarps];
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool s = j < C && surv[j] != 0;
  const unsigned mask = __ballot_sync(0xffffffffu, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(mask);
  __syncthreads();
  if (j >= C) return;
  if (s) {
    int32_t before = offsets[blockIdx.x];
    for (int w = 0; w < warp; ++w) before += warp_counts[w];
    const int64_t pos = before + __popc(mask & ((1u << lane) - 1u));
    out0[pos] = pay0[j];
    out1[pos] = pay1[j];
  }
  if (j >= *nsur) {  // survivors land below nsur, fills at and above it
    out0[j] = fill0;
    out1[j] = fill1;
  }
}

}  // namespace

extern "C" {

int tt_frontier_round_threads(void) { return kThreads; }

// Enqueues the round on `stream`; returns the cudaError_t of the launches.
// Scratch: surv [max(C,1)] u8, counts/offsets [max(ceil(C/256),1)] i32.
int tt_frontier_round(const int32_t* cols, const uint8_t* undec,
                      const uint8_t* has_more, const int32_t* pay0,
                      const int32_t* pay1, const uint8_t* fbits,
                      const uint8_t* tbits, const int32_t* dstT, int64_t C,
                      int K, int64_t Q, int64_t nb, int64_t tb, int lanes,
                      int fill0, int fill1, uint8_t* found, int32_t* out0,
                      int32_t* out1, int32_t* nsur, uint8_t* surv,
                      int32_t* counts, int32_t* offsets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nblocks = (C + kThreads - 1) / kThreads;
  if (C < 0 || C >= (int64_t(1) << 31) || K < 1 || Q < 1 || nb < 1 ||
      (tbits != nullptr && tb < 1) || (lanes != 2 && lanes != 8))
    return cudaErrorInvalidValue;
  if (C > 0) {
    round_test<<<(unsigned)nblocks, kThreads, 0, st>>>(
        cols, undec, has_more, fbits, tbits, dstT, C, K, Q, nb, tb, lanes,
        found, surv, counts);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  scan_counts<<<1, kScanThreads, 0, st>>>(counts, nblocks, offsets, nsur);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || C == 0) return e;
  compact<<<(unsigned)nblocks, kThreads, 0, st>>>(
      surv, offsets, nsur, pay0, pay1, C, fill0, fill1, out0, out1);
  return cudaGetLastError();
}

}  // extern "C"
