// bfs_fused: the whole direction-optimizing BFS in one cooperative launch,
// hand-written for Hopper (sm_90a).
//
// It replaces no Pallas kernel. Its counterpart in the JAX package is the
// XLA program of titan_tpu/models/bfs_hybrid_fused.py:311 (`_fused_bfs`):
// a `lax.while_loop` over levels whose body picks, from four counts kept
// on the device, the endgame, a top-down level or a bottom-up level, so a
// whole BFS costs one dispatch and one readback. Eager PyTorch cannot keep
// such a loop on the card; this kernel does: one persistent launch whose
// blocks all stay resident and meet at grid-wide barriers
// (cooperative_groups::this_grid().sync()). `fused_bfs_reference` in
// titan_tpu_torch/models/bfs_hybrid_fused.py is its plain version: the same
// decisions from the same counts, one level at a time from the host.
//
// Each level, every thread reads the same four counts (the frontier's
// size and chunk mass, the unvisited chunk mass and count, accumulated in
// int64) and takes the same decision, the JAX package's rule:
//
//   endgame   n_unvis <= end_c and m8_unvis <= end_p: list the unvisited
//             vertices once, then run bottom-up levels over that list
//             until one finds nothing;
//   bottom-up m8_f > m8_unvis / 8 and f > 1, or the frontier passes the
//             top top-down pair (top_f, top_p): every unvisited vertex
//             walks its chunks until a parent's bit is set in the
//             frontier bitmap;
//   top-down  otherwise: every frontier vertex walks its chunks and
//             stores level + 1 into each neighbour still at INF. Every
//             writer writes the same value, so a plain store does.
//
// The level count follows the JAX program's arithmetic: a top-down or
// bottom-up level adds one; the endgame adds one a level it runs, the
// last of which finds nothing, and one more for the empty probe
// (bfs_hybrid_fused.py:366-370), capped at max_levels. A level that finds
// nothing ends the BFS.
//
// What bounds it: bytes. A level gathers 32 bytes of dstT for each chunk
// column it walks, at random columns; the dist array (4n bytes, 268 MB at
// scale 26) does not fit the 50 MB L2, so each neighbour's test in a
// top-down level costs a sector of its own; the bitmap (n/8 bytes, 8 MB)
// does fit, so a bottom-up parent test mostly hits L2.
//
// What the design does about it:
//
//   1. The counts of level L+1 and its frontier bitmap come out of one
//      pass over dist after level L (a warp ballots 32 vertices into one
//      bitmap word and adds their counts), so a bottom-up level reads its
//      frontier from the bitmap, through frontier_words.cuh's word_of, the
//      function frontier_round.cu and batched_exhaust.cu use.
//   2. Work goes by degree. A vertex of up to kLight chunks is walked by
//      the thread that found it in the pass; one of up to kMid chunks is
//      appended to a list that a warp a vertex walks, 32 chunks at a time;
//      a larger one to a list that a block a vertex walks, kThreads chunks
//      at a time. A hub therefore never holds one thread for its whole
//      degree, and a bottom-up walk stops at the first stride that hits.
//      The appends are warp-aggregated: one atomic a warp.
//   3. A thread issues a chunk's 8 dstT loads together before testing any.
//
// dist and the bitmap change inside the launch, so they are read from L2
// (__ldcg) and written there (__stcg); the read-only cache serves only
// dstT, colstart and degc, which never change. Offsets are 64-bit
// (lane * Q passes 2^31 at scale 26). dist has n + 2 slots; only [0, n)
// is ever written. A neighbour or parent id at or past n (the pad n + 1)
// is skipped or tests a zero bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "frontier_words.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kInf = 1 << 30;
constexpr int32_t kLight = 4;    // chunks the finding thread walks itself
constexpr int32_t kMid = 256;    // chunks a warp walks; past it, a block
// the counters of one level, in a ring of 4 (see the kernel)
enum { kF = 0, kM8F, kM8U, kNU, kMidN, kHubN, kSlots = 8 };
constexpr int kRing = 4;
constexpr int kListN = kRing * kSlots;  // the endgame list's length
enum { kEndgame = 0, kTopDown = 1, kBottomUp = 2 };

using u64 = unsigned long long;

struct Args {
  int32_t* dist;              // [n + 2]
  const int32_t* dstT;        // [8, Q]
  const int32_t* colstart;    // [n + 1]
  const int32_t* degc;        // [n + 1]
  uint32_t* fbits;            // [nwords]: bit v = dist[v] == level
  int32_t* mid;               // [n] vertices walked a warp each
  int32_t* hub;               // [n] vertices walked a block each
  int32_t* list;              // [n] the endgame's candidates
  u64* ctr;                   // [kRing * kSlots + 1], zeroed by the caller
  int32_t* info;              // [2 + mode_cap]: levels, decisions, modes
  int64_t n, Q, nwords;
  int64_t end_c, end_p, top_f, top_p;
  int32_t max_lv, mode_cap;
};

__device__ __forceinline__ int32_t dist_at(const Args& a, int64_t v) {
  return __ldcg(a.dist + v);
}

__device__ __forceinline__ int64_t warp_id() {
  return (int64_t(blockIdx.x) * kThreads + threadIdx.x) >> 5;
}

__device__ __forceinline__ int64_t warp_count() {
  return (int64_t(gridDim.x) * kThreads) >> 5;
}

// Adds k (<= 4) per-thread values into dst[0..k), one atomic a block.
__device__ void block_add(u64* dst, u64 (&v)[4], int k) {
  __shared__ u64 red[kWarps][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < k; ++i) {
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_down_sync(~0u, v[i], o);
    if (lane == 0) red[warp][i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < k) {
    u64 s = 0;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    if (s != 0) atomicAdd(dst + threadIdx.x, s);
  }
  __syncthreads();
}

// Appends v to list for each lane that wants to: one atomic a warp. Every
// lane of the warp must call it.
__device__ __forceinline__ void warp_append(bool want, int32_t v,
                                            int32_t* list, u64* count) {
  const unsigned m = __ballot_sync(~0u, want);
  if (m == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  u64 base = 0;
  if (lane == leader) base = atomicAdd(count, u64(__popc(m)));
  base = __shfl_sync(~0u, base, leader);
  if (want) list[base + __popc(m & ((1u << lane) - 1u))] = v;
}

// The pass after a level: the counts of the next frontier (dist == next)
// and of the unvisited vertices into slot[kF..kNU], and the next
// frontier's bitmap.
__device__ void count_and_pack(const Args& a, int32_t next, u64* slot) {
  u64 acc[4] = {0, 0, 0, 0};
  const int lane = threadIdx.x & 31;
  for (int64_t w = warp_id(); w < a.nwords; w += warp_count()) {
    const int64_t v = w * 32 + lane;
    bool fr = false;
    if (v < a.n) {
      const int32_t d = dist_at(a, v), c = __ldg(a.degc + v);
      fr = d == next;
      if (fr) { acc[0] += 1; acc[1] += c; }
      if (d >= kInf) { acc[2] += c; acc[3] += c > 0; }
    }
    const unsigned bits = __ballot_sync(~0u, fr);
    if (lane == 0) __stcg(a.fbits + w, bits);
  }
  block_add(slot + kF, acc, 4);
}

// Top-down: store next into every neighbour of chunk column col at INF.
__device__ __forceinline__ void expand_chunk(const Args& a, int64_t col,
                                             int32_t next) {
  int32_t w[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) w[l] = __ldg(a.dstT + l * a.Q + col);
  int32_t d[8];
#pragma unroll
  for (int l = 0; l < 8; ++l)
    d[l] = uint32_t(w[l]) < uint64_t(a.n) ? dist_at(a, w[l]) : 0;
#pragma unroll
  for (int l = 0; l < 8; ++l)
    if (d[l] >= kInf) __stcg(a.dist + w[l], next);
}

// Bottom-up: does chunk column col hold a parent in the frontier?
__device__ __forceinline__ bool chunk_hits(const Args& a, int64_t col) {
  int32_t par[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) par[l] = __ldg(a.dstT + l * a.Q + col);
  const uint8_t* plane = reinterpret_cast<const uint8_t*>(a.fbits);
  uint32_t any = 0;
#pragma unroll
  for (int l = 0; l < 8; ++l)
    any |= word_of_t<true>(plane, a.nwords * 4, 0, par[l]);
  return any != 0;
}

// The first pass of a level: each vertex the level works on (the frontier
// top-down; the unvisited, or the endgame list's still unvisited,
// bottom-up) is walked here if light, else appended to the warp or block
// list of slot.
__device__ void scan(const Args& a, int mode, int32_t level, bool from_list,
                     int64_t nlist, u64* slot) {
  const int lane = threadIdx.x & 31;
  const int32_t next = level + 1;
  const int64_t total = from_list ? nlist : a.n;
  for (int64_t b = warp_id() * 32; b < total; b += warp_count() * 32) {
    const int64_t i = b + lane;
    int32_t v = -1, dc = 0;
    if (i < total) {
      v = from_list ? __ldcg(a.list + i) : int32_t(i);
      const int32_t d = dist_at(a, v);
      dc = __ldg(a.degc + v);
      const bool take = mode == kTopDown ? d == level : d >= kInf;
      if (!take || dc == 0) v = -1;
    }
    if (v >= 0 && dc <= kLight) {
      const int64_t cs = __ldg(a.colstart + v);
      if (mode == kTopDown) {
        for (int32_t c = 0; c < dc; ++c) expand_chunk(a, cs + c, next);
      } else {
        for (int32_t c = 0; c < dc; ++c)
          if (chunk_hits(a, cs + c)) { __stcg(a.dist + v, next); break; }
      }
    }
    warp_append(v >= 0 && dc > kLight && dc <= kMid, v, a.mid,
                slot + kMidN);
    warp_append(v >= 0 && dc > kMid, v, a.hub, slot + kHubN);
  }
}

// The second pass: the hub list a block a vertex, then the mid list a
// warp a vertex.
__device__ void walk_lists(const Args& a, int mode, int32_t level,
                           const u64* slot) {
  const int32_t next = level + 1;
  const int64_t nhub = int64_t(__ldcg(slot + kHubN));
  const int64_t nmid = int64_t(__ldcg(slot + kMidN));
  for (int64_t i = blockIdx.x; i < nhub; i += gridDim.x) {
    const int32_t v = __ldcg(a.hub + i);
    const int64_t cs = __ldg(a.colstart + v);
    const int32_t dc = __ldg(a.degc + v);
    if (mode == kTopDown) {
      for (int32_t c = threadIdx.x; c < dc; c += kThreads)
        expand_chunk(a, cs + c, next);
    } else {
      for (int32_t c0 = 0; c0 < dc; c0 += kThreads) {
        const int32_t c = c0 + threadIdx.x;
        if (__syncthreads_or(c < dc && chunk_hits(a, cs + c))) {
          if (threadIdx.x == 0) __stcg(a.dist + v, next);
          break;
        }
      }
    }
  }
  const int lane = threadIdx.x & 31;
  for (int64_t i = warp_id(); i < nmid; i += warp_count()) {
    const int32_t v = __ldcg(a.mid + i);
    const int64_t cs = __ldg(a.colstart + v);
    const int32_t dc = __ldg(a.degc + v);
    if (mode == kTopDown) {
      for (int32_t c = lane; c < dc; c += 32) expand_chunk(a, cs + c, next);
    } else {
      for (int32_t c0 = 0; c0 < dc; c0 += 32) {
        const int32_t c = c0 + lane;
        if (__any_sync(~0u, c < dc && chunk_hits(a, cs + c))) {
          if (lane == 0) __stcg(a.dist + v, next);
          break;
        }
      }
    }
  }
}

// The whole BFS. Level e's counts sit in ring slot e % 4; level e fills
// slot (e + 1) % 4, which the first thread zeroed at the top of level
// e - 1 (as its (e - 1 + 2) % 4). That slot was last read at the top of
// level e - 3, and three barriers a level lie between, so no thread still
// reads a slot that is being zeroed.
__global__ void __launch_bounds__(kThreads) bfs_fused_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  const bool boss = blockIdx.x == 0 && threadIdx.x == 0;
  count_and_pack(a, 0, a.ctr);          // level -1's counts: the source
  grid.sync();
  int32_t level = 0, levels = 0, nrec = 0;
  int64_t nlist = 0;
  bool endgame = false;
  for (int64_t e = 0;; ++e) {
    const u64* st = a.ctr + (e % kRing) * kSlots;
    const int64_t f = int64_t(__ldcg(st + kF));
    const int64_t m8f = int64_t(__ldcg(st + kM8F));
    const int64_t m8u = int64_t(__ldcg(st + kM8U));
    const int64_t nu = int64_t(__ldcg(st + kNU));
    u64* slot = a.ctr + ((e + 1) % kRing) * kSlots;
    int mode = kBottomUp;
    if (endgame) {
      // f is what the last endgame level found
      if (f == 0 || level >= a.max_lv) {
        levels = level + 1 < a.max_lv ? level + 1 : a.max_lv;
        break;
      }
    } else {
      if (f == 0 || level >= a.max_lv) {
        levels = level;
        break;
      }
      if (nu <= a.end_c && m8u <= a.end_p) {
        mode = kEndgame;
      } else if ((m8f > m8u / 8 && f > 1) || m8f > a.top_p ||
                 f > a.top_f) {
        mode = kBottomUp;
      } else {
        mode = kTopDown;
      }
      if (boss && nrec < a.mode_cap) a.info[2 + nrec] = mode;
      ++nrec;
    }
    if (boss) {
      u64* z = a.ctr + ((e + 2) % kRing) * kSlots;
      for (int k = 0; k < kSlots; ++k) z[k] = 0;
    }
    if (mode == kEndgame) {
      // list the unvisited vertices once
      const int lane = threadIdx.x & 31;
      for (int64_t b = warp_id() * 32; b < a.n; b += warp_count() * 32) {
        const int64_t v = b + lane;
        const bool want = v < a.n && dist_at(a, v) >= kInf &&
                          __ldg(a.degc + v) > 0;
        warp_append(want, int32_t(v), a.list, a.ctr + kListN);
      }
      grid.sync();
      nlist = int64_t(__ldcg(a.ctr + kListN));
      endgame = true;
    }
    const int work = mode == kTopDown ? kTopDown : kBottomUp;
    scan(a, work, level, endgame, nlist, slot);
    grid.sync();
    walk_lists(a, work, level, slot);
    grid.sync();
    count_and_pack(a, level + 1, slot);
    grid.sync();
    ++level;
  }
  if (boss) {
    a.info[0] = levels;
    a.info[1] = nrec;
  }
}

constexpr int kMaxDevices = 64;

// The blocks of bfs_fused_kernel that fit on the current device at once
// (a cooperative launch needs every block resident); worked out at the
// first call on each device.
cudaError_t resident_blocks(int* blocks) {
  static std::atomic<int> cached[kMaxDevices];  // 0: not worked out yet
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*blocks = cached[dev].load()) > 0)
    return cudaSuccess;
  int sms, per_sm, coop;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bfs_fused_kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) cached[dev].store(*blocks);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The length of the counter array the caller zeroes.
int tt_bfs_fused_counters() { return kListN + 1; }

// The blocks of one launch on the current device, or a negative
// cudaError_t.
int tt_bfs_fused_grid() {
  int blocks;
  const cudaError_t e = resident_blocks(&blocks);
  return e == cudaSuccess ? blocks : -int(e);
}

// Enqueues the BFS on `stream` (one cooperative launch); returns its
// cudaError_t. dist: [n + 2], INF but the source's 0; lists: [3, n]
// scratch; ctr: [tt_bfs_fused_counters()] zeros; info: [2 + mode_cap].
int tt_bfs_fused(int32_t* dist, const int32_t* dstT, const int32_t* colstart,
                 const int32_t* degc, uint32_t* fbits, int32_t* lists,
                 unsigned long long* ctr, int32_t* info, int64_t n,
                 int64_t Q, int64_t nwords, int64_t end_c, int64_t end_p,
                 int64_t top_f, int64_t top_p, int max_lv, int mode_cap,
                 void* stream) {
  if (n < 1 || Q < 1 || nwords * 32 < n + 2 || mode_cap < 0)
    return cudaErrorInvalidValue;
  int blocks;
  const cudaError_t e = resident_blocks(&blocks);
  if (e != cudaSuccess) return e;
  Args a{dist, dstT, colstart, degc, fbits, lists, lists + n, lists + 2 * n,
         ctr, info, n, Q, nwords, end_c, end_p, top_f, top_p, max_lv,
         mode_cap};
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(bfs_fused_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
