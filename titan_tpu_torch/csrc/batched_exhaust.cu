// batched_exhaust: the straggler sweep of the batched [K, n] BFS,
// hand-written for Hopper (sm_90a).
//
// Its counterpart in the JAX package is the found-per-candidate half of
// `_batched_exhaust` in titan_tpu/models/bfs_hybrid.py (the lines from
// `parents = jnp.take(...)` to `found_per`), which is XLA, not a Pallas
// kernel: the port adds this kernel for speed. It computes what
// `batched_exhaust_reference` in titan_tpu_torch/ops/frontier.py
// computes: for every (candidate, chunk) pair j < p_total, the OR of the
// frontier words (frontier_words.cuh) of the chunk's parents whose slot
// the tombstones leave open, folded by OR into the pair's candidate,
// out[g][owner[j]] for each plane g of 32 jobs. Pairs past p_total are
// skipped: their column is the pad column, their parents are pads, and
// the pads' bits are zero, so the plain version's fold of them into the
// last candidate adds nothing.
//
// What bounds it: bytes. At Graph500 scale 26 a level's sweep lists up
// to 2^28 pairs, so it must read cols and owner (2 GB) and nearly all of
// dstT (9 GB); the words (134 MB at K = 16) do not fit the 50 MB L2, so
// most parents' tests cost a sector of their own.
//
// What the design does about it:
//
//   1. One persistent launch of as many blocks as fit on the card; a
//      warp takes 32 consecutive pairs at a time, so its loads of cols
//      and owner are coalesced, and since the pairs of one candidate are
//      consecutive columns, so are its loads of each dstT row. p_total is
//      read on the device: the host never waits for it.
//   2. A thread issues its pair's 8 dstT loads together, then one word
//      load a parent for all the jobs of a plane, all before any is used.
//   3. The pairs of one candidate are contiguous, so a warp folds them
//      itself: __match_any_sync on the owner groups its lanes by
//      candidate, __reduce_or_sync ORs their words, and the group's
//      lowest lane does one atomicOr, only when some job hit. A hub
//      spanning thousands of warps takes at most one atomic a warp; the
//      dead pairs, which the plain version folds into the last candidate,
//      take none. OR is order-free, so the result is bit-equal run to run.
//
// Offsets are 64-bit (lane*Q passes 2^31 at scale 26). Every gather is
// clamped into its array as the plain version clamps it: cols to
// [0, Q-1], the tombstone byte (slot col*8 + lane is byte col) to
// [0, tb-1], a parent's word as word_of says. Owners outside [0, c_cap)
// are dropped, as the plain version drops them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "frontier_words.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const int32_t* __restrict__ cols;
  const int32_t* __restrict__ owner;
  const int32_t* __restrict__ p_total;
  const uint8_t* __restrict__ fbits;
  const uint8_t* __restrict__ tbits;
  const int32_t* __restrict__ dstT;
  int64_t P, Q, nb, tb, c_cap;  // nb: the bytes of one plane of words
  int G, kp_log;
  uint32_t* __restrict__ out;   // [G, c_cap], zeroed by the caller
};

__global__ void __launch_bounds__(kThreads)
batched_exhaust_kernel(const Args a) {
  const int64_t pt = __ldg(a.p_total);
  const int64_t live = pt < 0 ? 0 : (pt < a.P ? pt : a.P);
  const int lane = threadIdx.x & 31;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  // j - lane, the warp's first pair, is the same on every lane: the warp
  // runs the loop together, as the warp-wide intrinsics need
  for (int64_t j = int64_t(blockIdx.x) * kThreads + threadIdx.x;
       j - lane < live; j += stride) {
    const bool in = j < live;
    int32_t col = 0, own = -1;
    uint32_t open = 0;
    if (in) {
      col = int32_t(clamp64(__ldg(a.cols + j), 0, a.Q - 1));
      own = __ldg(a.owner + j);
      open = a.tbits == nullptr
                 ? 0xffu
                 : ~uint32_t(__ldg(a.tbits + clamp64(col, 0, a.tb - 1))) &
                       0xffu;
    }
    int32_t par[8];
#pragma unroll
    for (int l = 0; l < 8; ++l)
      par[l] = (open >> l) & 1u ? __ldg(a.dstT + l * a.Q + col) : 0;
    const bool mine = in && own >= 0 && own < a.c_cap;
    const unsigned peers = __match_any_sync(~0u, mine ? own : -1);
    const bool leader = lane == __ffs(peers) - 1;
    for (int g = 0; g < a.G; ++g) {
      const uint8_t* plane = a.fbits + int64_t(g) * a.nb;
      uint32_t w[8];
#pragma unroll
      for (int l = 0; l < 8; ++l)
        w[l] = (open >> l) & 1u ? word_of(plane, a.nb, a.kp_log, par[l])
                                : 0u;
      uint32_t any = 0;
#pragma unroll
      for (int l = 0; l < 8; ++l) any |= w[l];
      const uint32_t acc = __reduce_or_sync(peers, any);
      if (mine && leader && acc != 0u)
        atomicOr(a.out + int64_t(g) * a.c_cap + own, acc);
    }
  }
}

constexpr int kMaxDevices = 64;

// The blocks of batched_exhaust_kernel that fit on the current device at
// once; worked out at the first call on each device.
cudaError_t resident_blocks(int* blocks) {
  static std::atomic<int> cached[kMaxDevices];  // 0: not worked out yet
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*blocks = cached[dev].load()) > 0)
    return cudaSuccess;
  int sms, per_sm;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, batched_exhaust_kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) cached[dev].store(*blocks);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Enqueues the sweep on `stream` (one launch, none at P = 0); returns its
// cudaError_t. fbits: ceil(K / 32) planes of nb bytes of words; out:
// [ceil(K / 32), c_cap] 32-bit words, zeroed by the caller.
int tt_batched_exhaust(const int32_t* cols, const int32_t* owner,
                       const int32_t* p_total, const uint8_t* fbits,
                       const uint8_t* tbits, const int32_t* dstT, int64_t P,
                       int K, int64_t Q, int64_t nb, int64_t tb,
                       int64_t c_cap, uint32_t* out, void* stream) {
  const int kp_log = word_log2(K);
  const int64_t word_bytes = kp_log >= 3 ? int64_t(1) << (kp_log - 3) : 1;
  if (P < 0 || K < 1 || Q < 1 || nb < 1 || c_cap < 1 ||
      nb % word_bytes != 0 ||
      reinterpret_cast<uintptr_t>(fbits) % word_bytes != 0 ||
      (tbits != nullptr && tb < 1))
    return cudaErrorInvalidValue;
  if (P == 0) return cudaSuccess;
  int resident;
  const cudaError_t e = resident_blocks(&resident);
  if (e != cudaSuccess) return e;
  const int64_t need = (P + kThreads - 1) / kThreads;
  const int64_t grid = need < resident ? need : resident;
  const Args a{cols, owner, p_total, fbits, tbits, dstT, P, Q, nb, tb,
               c_cap, (K + 31) / 32, kp_log, out};
  batched_exhaust_kernel<<<(unsigned)grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
