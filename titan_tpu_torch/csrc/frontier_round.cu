// frontier_round: the fused bottom-up chunk round of the direction-
// optimizing BFS, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_frontier_round_kernel` launched by
// `frontier_round` in titan_tpu/ops/pallas_frontier.py. It computes what
// that kernel computes (see titan_tpu_torch/ops/frontier.py for the
// contract and `frontier_round_reference` for the plain version), not
// what it does block by block: the TPU kernel keeps survivor order with
// an SMEM cursor carried across a SEQUENTIAL grid, and CUDA blocks run in
// no order.
//
// What bounds it: bytes, most of them random. dstT is [8, Q] int32, so
// each fetched lane entry of a random column is its own 32-byte sector (a
// candidate's 8 lanes lie Q*4 bytes apart). The frontier is n/8 bytes
// for one job (8.4 MB at Graph500 scale 26) and stays in the 50 MB L2;
// K jobs' frontiers are vertex-major words (ops/frontier.py's module doc:
// Kp bits a vertex in each plane of 32 jobs), 134 MB at K = 16, past the
// L2, so a parent's test costs a sector, and the words make that one
// sector for all the jobs of a plane instead of one a job. The rest is
// read or written once, coalesced. Each candidate's reads form a chain
// (its column, then its parents, then their words, then the refetch of
// the other lanes and their words), so the rate is set by how many
// candidates the card keeps in flight and by the fixed latency each tile
// adds, not by the memory's rate.
//
// What the design does about it: one persistent pass, one launch.
//
//   1. Blocks, as many as fit on the card at once, take tiles of kTile
//      candidates from an atomic ticket. Thread t tests candidates t,
//      t + kThreads, ... of its tile, so every warp-wide load of cols,
//      undec and has_more and every store of found covers neighbouring
//      candidates, and the gathers of rising, closely spaced columns (the
//      opener's candidates, in vertex order) share sectors.
//   2. A thread issues the narrow dstT loads of all its candidates before
//      it tests any, then all their parents' words (one load a parent for
//      every job of a plane: hit |= word & want), then the refetch of the
//      other lanes of every candidate that some undecided job missed,
//      together, tested only for the jobs that missed (want & ~hit). A
//      candidate that no job still wants is not gathered. undec, the hits
//      and the survivor flags stay in registers; found is written once.
//      The round with one job (K = 1, the BFS main path) is its own
//      instantiation, without the job loops, its word a bit of a byte.
//      Indices and columns are 32-bit (C < 2^31 and cols is int32); only
//      the offsets of rows and lanes are 64-bit.
//   3. Survivors are ranked in candidate order: a ballot per item and
//      warp, then one warp's scan of the kItems * kWarps run counts. The
//      tile publishes its survivor count; the count before it comes from
//      decoupled look-back over the earlier tiles' statuses (Merrill and
//      Garland, "Single-pass Parallel Prefix Scan with Decoupled
//      Look-back", NVIDIA 2016). The counts are integers, so the order of
//      the fold does not matter.
//   4. As in seg_scan.cu, a block publishes tile i and only then finishes
//      tile i - 1, so the predecessors have had a round to publish and the
//      walk seldom waits. While tile i is tested the ticket of tile i + 1
//      is in flight; while the walk runs, tile i + 1's coalesced inputs
//      and the payloads of tile i - 1's survivors are.
//   5. A status word holds its own count, so the statuses are read and
//      written with relaxed accesses at device scope: no fence. (A
//      release store waits for the thread's earlier stores, found
//      included, to be visible; that fence cost more than the walk.)
//   6. Every candidate writes one slot. A survivor with s survivors before
//      it writes (pay0, pay1) to slot s; a non-survivor at index j, with
//      s survivors before it, writes (fill0, fill1) to slot
//      C - 1 - (j - s). The non-survivors, in order, fill slots C - 1 down
//      to nsur, each once, so the fills need neither nsur nor a second
//      launch. The block that finishes the last tile writes nsur.
//
// Jobs go in groups of kJobs, one plane of words each, one bit each in a
// 32-bit word of wants and hits; K > kJobs runs the gathers once a group.
//
// Forward progress does not rely on the order in which blocks are
// dispatched: a tile's ticket goes only to a running block, which
// publishes the tile's count before it waits on anything, and tile 0
// publishes its count as a prefix, so every walk ends.
//
// The statuses and the ticket live in a scratch array of
// ceil(C / kTile) + 1 64-bit words that the wrapper zeroes before every
// call, so no call reads a status of an earlier one.
//
// Offsets: dstT offsets (lane*Q + col), the rows of undec and found
// (k*C + j) and the slots are 64-bit: at scale 26 Q is about 282M, so
// lane*Q passes 2^31. Every gather is clamped into its array (cols to
// [0, Q-1], a parent's word into its plane as word_of says, the
// tombstone byte of slot col*8 + lane, which is byte col, to [0, tb-1]),
// as the plain version clamps them: an out-of-range read must never
// fault the context.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "frontier_words.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 2;                  // candidates a thread
constexpr int kTile = kThreads * kItems;   // candidates a tile
constexpr int kRuns = kItems * kWarps;     // runs of 32 candidates a tile
constexpr int kJobs = 32;                  // jobs a word of bits holds
static_assert(kThreads % 32 == 0 && kRuns <= 32, "one warp scans the runs");

// status word: the state in the high 32 bits, the count in the low
constexpr uint32_t kInvalid = 0;     // not published yet (zeroed scratch)
constexpr uint32_t kAggregate = 1;   // the tile's own survivor count
constexpr uint32_t kPrefix = 2;      // the survivors up to the tile's end

__device__ __forceinline__ uint64_t status_word(uint32_t state,
                                                uint32_t count) {
  return (uint64_t(state) << 32) | count;
}
// A status word carries its own count, so no other memory has to be
// ordered around it: relaxed accesses at device scope, no fence.
__device__ __forceinline__ uint64_t ld_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}
// index of the highest set bit, -1 for none
__device__ __forceinline__ int msb(unsigned m) { return 31 - __clz(m); }

// The survivors before `tile` (> 0), by one whole warp; every lane
// returns it. Walks back over windows of 32 statuses until a window holds
// a prefix with nothing unpublished after it, adding the counts.
__device__ int32_t look_back(const uint64_t* status, int64_t tile) {
  const int lane = threadIdx.x & 31;
  uint32_t acc = 0;
  for (int64_t end = tile;;) {
    const int64_t i = end - 32 + lane;
    // before tile 0: a prefix of 0, below the lanes that hold tiles
    const uint64_t w = i >= 0 ? ld_status(status + i)
                              : status_word(kPrefix, 0);
    const uint32_t s = uint32_t(w >> 32);
    const unsigned pre = __ballot_sync(~0u, s == kPrefix);
    const unsigned inv = __ballot_sync(~0u, s == kInvalid);
    const int p = msb(pre);
    if (p > msb(inv))   // a prefix, and every tile after it published
      return int32_t(acc + __reduce_add_sync(
                               ~0u, lane >= p ? uint32_t(w) : 0u));
    if (inv == 0) {     // 32 counts: add them, one window further
      acc += __reduce_add_sync(~0u, uint32_t(w));
      end -= 32;
    }                   // else read the window again
  }
}

struct Args {
  const int32_t* __restrict__ cols;
  const uint8_t* __restrict__ undec;
  const uint8_t* __restrict__ has_more;
  const int32_t* __restrict__ pay0;
  const int32_t* __restrict__ pay1;
  const uint8_t* __restrict__ fbits;
  const uint8_t* __restrict__ tbits;
  const int32_t* __restrict__ dstT;
  int64_t C, Q, nb, tb;  // nb: the bytes of one plane of words
  int K;
  int kp_log;             // log2 of Kp, the bits a vertex in a plane
  int32_t fill0, fill1;
  uint8_t* __restrict__ found;
  int32_t* __restrict__ out0;
  int32_t* __restrict__ out1;
  int32_t* __restrict__ nsur;
  uint64_t* __restrict__ status;
  unsigned* __restrict__ ticket;
};

// The jobs of `want` that some parent in lanes [l0, l1), open under the
// tombstones, holds in the plane: one word load a parent, all of them
// issued before any is tested. kOne: K = 1, Kp = 1 at compile time.
template <int l0, int l1, bool kOne>
__device__ __forceinline__ uint32_t hits(const uint8_t* __restrict__ plane,
                                         int64_t nb, int kp_log,
                                         const int32_t* par, uint32_t open,
                                         uint32_t want) {
  uint32_t w[l1 - l0];
#pragma unroll
  for (int l = l0; l < l1; ++l)
    w[l - l0] = (open >> l) & 1u
                    ? word_of(plane, nb, kOne ? 0 : kp_log, par[l]) : 0u;
  uint32_t any = 0;
#pragma unroll
  for (int l = 0; l < l1 - l0; ++l) any |= w[l];
  return any & want;
}

// The coalesced inputs of the thread's kItems candidates of a tile
// (candidate r at j0 + r * kThreads), loaded a round before their test.
struct Staged {
  int32_t col[kItems];    // as given; clamped at the test
  uint32_t want[kItems];  // bit k: job k < kJobs still undecided
  unsigned more;          // bit r: candidate r has more chunks
};

template <bool kOne>
__device__ __forceinline__ void stage(const Args& a, int64_t j0,
                                      Staged& st) {
  const int kn = kOne ? 1 : (a.K < kJobs ? a.K : kJobs);
  st.more = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t j = j0 + r * kThreads;
    st.col[r] = 0;
    st.want[r] = 0;
    if (j < a.C) {
      st.col[r] = a.cols[j];
      st.more |= uint32_t(a.has_more[j] != 0) << r;
      for (int k = 0; k < kn; ++k)
        st.want[r] |= uint32_t(a.undec[int64_t(k) * a.C + j] != 0) << k;
    }
  }
}

// Tests the thread's kItems candidates of a tile from their staged
// inputs, each gather of all of them issued before any is tested: writes
// their found rows and returns their survivor flags (bit r: some
// undecided job missed in every lane, and it has more chunks).
// kOne: the round has one job (K = 1), so the job loops fall away.
template <int kLanes, bool kOne>
__device__ unsigned test_items(const Args& a, int64_t j0, const Staged& st) {
  int32_t col[kItems];  // fits: cols is int32 and the clamp only lowers it
  uint32_t open[kItems];
  unsigned in = 0, missed = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    col[r] = int32_t(clamp64(st.col[r], 0, a.Q - 1));
    open[r] = 0xffu;
    if (j0 + r * kThreads < a.C) {
      in |= 1u << r;
      if (a.tbits != nullptr)
        open[r] =
            ~uint32_t(__ldg(a.tbits + clamp64(col[r], 0, a.tb - 1))) & 0xffu;
    }
  }
  const int K = kOne ? 1 : a.K;
  for (int g = 0; g < K; g += kJobs) {
    const int kn = kOne ? 1 : (K - g < kJobs ? K - g : kJobs);
    const uint8_t* plane = a.fbits + int64_t(g / kJobs) * a.nb;
    uint32_t want[kItems], hit[kItems];
    int32_t par[kItems][8];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      want[r] = g == 0 ? st.want[r] : 0u;
      hit[r] = 0;
      if (g > 0 && ((in >> r) & 1u))
        for (int k = 0; k < kn; ++k)
          want[r] |= uint32_t(a.undec[int64_t(g + k) * a.C + j0 +
                                      r * kThreads] != 0) << k;
    }
    // a candidate no job wants is not gathered
#pragma unroll
    for (int r = 0; r < kItems; ++r)
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
        if (want[r]) par[r][l] = __ldg(a.dstT + l * a.Q + col[r]);
#pragma unroll
    for (int r = 0; r < kItems; ++r)
      if (want[r])
        hit[r] = hits<0, kLanes, kOne>(plane, a.nb, a.kp_log, par[r],
                                       open[r], want[r]);
    if constexpr (kLanes < 8) {
      // the wide refetch, only for the jobs that missed the narrow lanes
      uint32_t need[kItems];
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        need[r] = want[r] & ~hit[r];
#pragma unroll
        for (int l = kLanes; l < 8; ++l)
          if (need[r]) par[r][l] = __ldg(a.dstT + l * a.Q + col[r]);
      }
#pragma unroll
      for (int r = 0; r < kItems; ++r)
        if (need[r])
          hit[r] |= hits<kLanes, 8, kOne>(plane, a.nb, a.kp_log, par[r],
                                          open[r], need[r]);
    }
    uint8_t* found = a.found + int64_t(g) * a.C + j0;
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if ((in >> r) & 1u)
        for (int k = 0; k < kn; ++k)
          found[int64_t(k) * a.C + r * kThreads] = (hit[r] >> k) & 1u;
      missed |= uint32_t((want[r] & ~hit[r]) != 0) << r;
    }
  }
  return missed & st.more;
}

// Persistent: a block takes tiles of kTile candidates by ticket until they
// run out. In round i it tests its tile i and publishes its survivor
// count, then finishes its tile i - 1: looks back for the count before it
// and writes the slots. By then the tiles before i - 1 have had a round
// to publish, so the walk seldom waits. The ticket of tile i + 1 is taken
// while tile i is tested, and its coalesced inputs are loaded while the
// walk runs.
template <int kLanes, bool kOne>
__global__ void __launch_bounds__(kThreads)
frontier_round_kernel(const Args a) {
  __shared__ unsigned s_ticket[2];  // the next tile, by round parity
  // survivors before each run (item, warp) of the tile tested this round
  // and of the tile finished, by round parity; [kRuns]: the tile's count
  __shared__ int32_t s_before[2][kRuns + 1];
  __shared__ int32_t s_base;  // survivors before the tile finished
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // C < 2^31, so tiles and tickets fit in 32 bits
  const int ntiles = int((a.C + kTile - 1) / kTile);
  if (tid == 0) s_ticket[0] = atomicAdd(a.ticket, 1u);
  __syncthreads();
  int tile = int(s_ticket[0]), prev = -1;
  unsigned prev_surv = 0;
  Staged st;
  if (tile < ntiles) stage<kOne>(a, int64_t(tile) * kTile + tid, st);
  for (int i = 0;; ++i) {
    int32_t* before_cur = s_before[i & 1];
    const int32_t* before_prev = s_before[(i & 1) ^ 1];
    if (tid == 0 && tile < ntiles)
      s_ticket[(i + 1) & 1] = atomicAdd(a.ticket, 1u);
    unsigned surv = 0;
    if (tile < ntiles) {
      surv = test_items<kLanes, kOne>(a, int64_t(tile) * kTile + tid, st);
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const unsigned m = __ballot_sync(~0u, (surv >> r) & 1u);
        if (lane == 0) before_cur[r * kWarps + warp] = __popc(m);
      }
    }
    __syncthreads();
    const int next = tile < ntiles ? int(s_ticket[(i + 1) & 1]) : ntiles;
    if (next < ntiles) stage<kOne>(a, int64_t(next) * kTile + tid, st);
    // the finished tile's survivors' payloads, in flight during the walk
    const int64_t jp = int64_t(prev) * kTile + tid;
    int32_t p0[kItems], p1[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      p0[r] = p1[r] = 0;
      if ((prev_surv >> r) & 1u) {
        p0[r] = a.pay0[jp + r * kThreads];
        p1[r] = a.pay1[jp + r * kThreads];
      }
    }
    if (warp == 0) {
      if (tile < ntiles) {
        // exclusive scan of the run counts, in candidate order
        const int32_t c = lane < kRuns ? before_cur[lane] : 0;
        int32_t x = c;
#pragma unroll
        for (int d = 1; d < kRuns; d <<= 1) {
          const int32_t y = __shfl_up_sync(~0u, x, d);
          if (lane >= d) x += y;
        }
        const int32_t count = __shfl_sync(~0u, x, kRuns - 1);
        if (lane < kRuns) before_cur[lane] = x - c;
        if (lane == 0) {
          before_cur[kRuns] = count;
          st_status(a.status + tile,
                    status_word(tile == 0 ? kPrefix : kAggregate, count));
        }
      }
      if (prev >= 0) {
        const int32_t before = prev > 0 ? look_back(a.status, prev) : 0;
        if (lane == 0) {
          const int32_t through = before + before_prev[kRuns];
          s_base = before;
          if (prev > 0)
            st_status(a.status + prev, status_word(kPrefix, through));
          if (prev == ntiles - 1) *a.nsur = through;
        }
      }
    }
    __syncthreads();
    if (prev >= 0) {
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const bool s = (prev_surv >> r) & 1u;
        const unsigned m = __ballot_sync(~0u, s);
        const int64_t j = jp + r * kThreads;
        const int64_t before = int64_t(s_base) + before_prev[r * kWarps + warp]
                               + __popc(m & ((1u << lane) - 1u));
        if (s) {
          a.out0[before] = p0[r];
          a.out1[before] = p1[r];
        } else if (j < a.C) {
          const int64_t slot = a.C - 1 - (j - before);
          a.out0[slot] = a.fill0;
          a.out1[slot] = a.fill1;
        }
      }
    }
    if (tile >= ntiles) return;
    prev = tile;
    prev_surv = surv;
    tile = next;
  }
}

constexpr int kMaxDevices = 64;

// The blocks of frontier_round_kernel<kLanes, kOne> that fit on the
// current device at once. The occupancy query runs at the first call on
// each device; later calls read the cached count.
template <int kLanes, bool kOne>
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
        &per_sm, frontier_round_kernel<kLanes, kOne>, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) cached[dev].store(*blocks);
  return cudaSuccess;
}

template <int kLanes, bool kOne>
int launch(const Args& a, cudaStream_t st) {
  const int64_t ntiles = (a.C + kTile - 1) / kTile;
  int resident;
  const cudaError_t e = resident_blocks<kLanes, kOne>(&resident);
  if (e != cudaSuccess) return e;
  // the blocks that fit on the card at once, no more than the tiles
  const int64_t grid = ntiles < resident ? ntiles : resident;
  frontier_round_kernel<kLanes, kOne><<<(unsigned)grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tt_frontier_round_tile(void) { return kTile; }

// Enqueues the round on `stream` (one launch; at C = 0 a memset of nsur
// instead); returns its cudaError_t. fbits: ceil(K / 32) planes of nb
// bytes of words, Kp = min(next_pow2(K), 32) bits a vertex. Scratch:
// ceil(C / tt_frontier_round_tile()) + 1 64-bit words, zeroed before
// every call (the tile statuses, then the ticket counter).
int tt_frontier_round(const int32_t* cols, const uint8_t* undec,
                      const uint8_t* has_more, const int32_t* pay0,
                      const int32_t* pay1, const uint8_t* fbits,
                      const uint8_t* tbits, const int32_t* dstT, int64_t C,
                      int K, int64_t Q, int64_t nb, int64_t tb, int lanes,
                      int fill0, int fill1, uint8_t* found, int32_t* out0,
                      int32_t* out1, int32_t* nsur, void* scratch,
                      void* stream) {
  const int kp_log = word_log2(K);
  const int64_t word_bytes = kp_log >= 3 ? int64_t(1) << (kp_log - 3) : 1;
  if (C < 0 || C >= (int64_t(1) << 31) || K < 1 || Q < 1 || nb < 1 ||
      nb % word_bytes != 0 ||
      reinterpret_cast<uintptr_t>(fbits) % word_bytes != 0 ||
      (tbits != nullptr && tb < 1) || (lanes != 2 && lanes != 8))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 0) return cudaMemsetAsync(nsur, 0, sizeof(int32_t), st);
  const int64_t ntiles = (C + kTile - 1) / kTile;
  uint64_t* status = static_cast<uint64_t*>(scratch);
  const Args a{cols, undec, has_more, pay0, pay1, fbits, tbits, dstT,
               C, Q, nb, tb, K, kp_log, fill0, fill1, found, out0, out1,
               nsur, status, reinterpret_cast<unsigned*>(status + ntiles)};
  if (K == 1)
    return lanes == 2 ? launch<2, true>(a, st) : launch<8, true>(a, st);
  return lanes == 2 ? launch<2, false>(a, st) : launch<8, false>(a, st);
}

}  // extern "C"
