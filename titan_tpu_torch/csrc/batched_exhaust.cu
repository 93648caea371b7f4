// batched_exhaust: the straggler sweep of the batched [K, n] BFS,
// hand-written for Hopper (sm_90a), and the frontier summary it reads.
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
// dstT (9 GB). The words (134 MB at K = 16) do not fit the 50 MB L2, so
// a parent's word costs a 32-byte sector of its own: 8 random sectors a
// pair, about 52 GB at the cohort's largest sweep, nearly all of them
// zero, since the batched BFS is bottom-up only and that sweep runs at
// level 0, where the 16 frontiers hold 16 vertices.
//
// What the design does about it:
//
//   1. A summary of the frontiers: bit s is set when some byte of
//      [s << sh, (s + 1) << sh) of some plane is nonzero, 2^sh bytes a
//      bit, sh the least that keeps the summary within kMaxSummaryWords
//      (32 KB) and a word inside one bit's bytes. exhaust_summary_kernel
//      builds it from the words just before the sweep, on the same
//      stream; every block of the sweep copies it into shared memory
//      once, and a parent whose bit is clear costs no global load: its
//      word is zero in every plane. The bit is found from the byte the
//      word load would start at, with word_of's clamps (word_byte), so a
//      clamped parent tests the block of the word it would have loaded.
//      Tombstones still decide which slots are open; the summary only
//      skips loads whose value would be zero, so the result is the same.
//   2. One persistent launch of as many blocks as fit on the card; a
//      warp takes 32 consecutive pairs at a time, so its loads of cols
//      and owner are coalesced, and since the pairs of one candidate are
//      consecutive columns, so are its loads of each dstT row. cols,
//      owner and dstT are read once, with the streaming hint (__ldcs), so
//      they do not push the words out of L2. p_total is read on the
//      device: the host never waits for it.
//   3. A thread issues its pair's 8 dstT loads together, then one word
//      load a live parent for all the jobs of a plane, all before any is
//      used.
//   4. The pairs of one candidate are contiguous, so a warp folds them
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
// the summary's 32-bit words at most: 2^18 bits in 32 KB of shared memory
constexpr int64_t kMaxSummaryWords = 1 << 13;

struct Args {
  const int32_t* __restrict__ cols;
  const int32_t* __restrict__ owner;
  const int32_t* __restrict__ p_total;
  const uint8_t* __restrict__ fbits;
  const uint8_t* __restrict__ tbits;
  const int32_t* __restrict__ dstT;
  const uint32_t* __restrict__ summ;  // [nsw], exhaust_summary_kernel's
  int64_t P, Q, nb, tb, c_cap, nsw;   // nb: the bytes of one plane of words
  int G, kp_log, sh;
  uint32_t* __restrict__ out;   // [G, c_cap], zeroed by the caller
};

// Bit s of summ: some byte of [s << sh, (s + 1) << sh) of some of the G
// planes of nb bytes is nonzero. One thread a bit; every word of summ is
// written.
__global__ void __launch_bounds__(kThreads)
exhaust_summary_kernel(const uint8_t* __restrict__ fbits, int64_t nb, int G,
                       int sh, int64_t nsw, uint32_t* __restrict__ summ) {
  const int64_t s = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t lo0 = s << sh;
  const int64_t hi0 = lo0 + (int64_t(1) << sh) < nb
                          ? lo0 + (int64_t(1) << sh) : nb;
  uint32_t acc = 0;
  for (int g = 0; g < G && acc == 0; ++g) {
    const uint8_t* p = fbits + int64_t(g) * nb;
    int64_t i = lo0;
    for (; i < hi0 && (reinterpret_cast<uintptr_t>(p + i) & 15); ++i)
      acc |= __ldg(p + i);
    for (; i + 16 <= hi0; i += 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + i));
      acc |= v.x | v.y | v.z | v.w;
    }
    for (; i < hi0; ++i) acc |= __ldg(p + i);
  }
  const unsigned bits = __ballot_sync(~0u, acc != 0);
  if ((threadIdx.x & 31) == 0 && (s >> 5) < nsw) summ[s >> 5] = bits;
}

// 3 blocks an SM, as before the summary (at most 85 registers)
__global__ void __launch_bounds__(kThreads, 3)
batched_exhaust_kernel(const Args a) {
  extern __shared__ uint32_t s_summ[];
  for (int64_t i = threadIdx.x; i < a.nsw; i += kThreads)
    s_summ[i] = __ldg(a.summ + i);
  __syncthreads();
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
      col = int32_t(clamp64(__ldcs(a.cols + j), 0, a.Q - 1));
      own = __ldcs(a.owner + j);
      open = a.tbits == nullptr
                 ? 0xffu
                 : ~uint32_t(__ldg(a.tbits + clamp64(col, 0, a.tb - 1))) &
                       0xffu;
    }
    int32_t par[8];
#pragma unroll
    for (int l = 0; l < 8; ++l)
      par[l] = (open >> l) & 1u ? __ldcs(a.dstT + l * a.Q + col) : 0;
    // the open parents whose summary bit is set: the only words to load
    uint32_t live_par = 0;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int64_t s = word_byte(a.nb, a.kp_log, par[l]) >> a.sh;
      live_par |= ((open >> l) & (s_summ[s >> 5] >> (s & 31)) & 1u) << l;
    }
    const bool mine = in && own >= 0 && own < a.c_cap;
    const unsigned peers = __match_any_sync(~0u, mine ? own : -1);
    const bool leader = lane == __ffs(peers) - 1;
    for (int g = 0; g < a.G; ++g) {
      const uint8_t* plane = a.fbits + int64_t(g) * a.nb;
      uint32_t w[8];
#pragma unroll
      for (int l = 0; l < 8; ++l)
        w[l] = (live_par >> l) & 1u ? word_of(plane, a.nb, a.kp_log, par[l])
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
// once with the largest summary in shared memory; worked out at the
// first call on each device.
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
        &per_sm, batched_exhaust_kernel, kThreads,
        kMaxSummaryWords * sizeof(uint32_t));
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) cached[dev].store(*blocks);
  return cudaSuccess;
}

// The summary's shape is the caller's (summary_shape in ops/frontier.py):
// a word's bytes inside one bit's, the planes covered, within the cap.
bool summary_fits(int64_t nb, int kp_log, int sh, int64_t nsw) {
  const int word_log = kp_log >= 3 ? kp_log - 3 : 0;
  return sh >= word_log && sh < 40 && nsw >= 1 &&
         nsw <= kMaxSummaryWords && ((nsw * 32) << sh) >= nb;
}

}  // namespace

extern "C" {

// Enqueues the summary of the K jobs' words on `stream` (one launch);
// returns its cudaError_t. fbits: ceil(K / 32) planes of nb bytes;
// summ: [nsw] 32-bit words, every one written.
int tt_exhaust_summary(const uint8_t* fbits, int K, int64_t nb, int sh,
                       int64_t nsw, uint32_t* summ, void* stream) {
  if (K < 1 || nb < 1 || !summary_fits(nb, word_log2(K), sh, nsw))
    return cudaErrorInvalidValue;
  const int64_t grid = (nsw * 32 + kThreads - 1) / kThreads;
  exhaust_summary_kernel<<<(unsigned)grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      fbits, nb, (K + 31) / 32, sh, nsw, summ);
  return cudaGetLastError();
}

// Enqueues the sweep on `stream` (one launch, none at P = 0); returns its
// cudaError_t. fbits: ceil(K / 32) planes of nb bytes of words; summ: the
// [nsw] summary of fbits (tt_exhaust_summary, 2^sh bytes a bit); out:
// [ceil(K / 32), c_cap] 32-bit words, zeroed by the caller.
int tt_batched_exhaust(const int32_t* cols, const int32_t* owner,
                       const int32_t* p_total, const uint8_t* fbits,
                       const uint8_t* tbits, const int32_t* dstT,
                       const uint32_t* summ, int64_t P, int K, int64_t Q,
                       int64_t nb, int64_t tb, int64_t c_cap, int sh,
                       int64_t nsw, uint32_t* out, void* stream) {
  const int kp_log = word_log2(K);
  const int64_t word_bytes = kp_log >= 3 ? int64_t(1) << (kp_log - 3) : 1;
  if (P < 0 || K < 1 || Q < 1 || nb < 1 || c_cap < 1 ||
      nb % word_bytes != 0 ||
      reinterpret_cast<uintptr_t>(fbits) % word_bytes != 0 ||
      (tbits != nullptr && tb < 1) || !summary_fits(nb, kp_log, sh, nsw))
    return cudaErrorInvalidValue;
  if (P == 0) return cudaSuccess;
  int resident;
  cudaError_t e = resident_blocks(&resident);
  if (e != cudaSuccess) return e;
  const int smem = int(nsw * sizeof(uint32_t));
  const int64_t need = (P + kThreads - 1) / kThreads;
  const int64_t grid = need < resident ? need : resident;
  const Args a{cols, owner, p_total, fbits, tbits, dstT, summ, P, Q, nb, tb,
               c_cap, nsw, (K + 31) / 32, kp_log, sh, out};
  batched_exhaust_kernel<<<(unsigned)grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
