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
// size and chunk mass, the unvisited chunk mass and count, in int64) and
// takes the same decision, the JAX package's rule:
//
//   endgame   n_unvis <= end_c and m8_unvis <= end_p: bottom-up levels
//             until one finds nothing;
//   bottom-up m8_f > m8_unvis / 8 and f > 1, or the frontier passes the
//             top top-down pair (top_f, top_p): every unvisited vertex
//             walks its chunks until a parent's bit is set in the
//             frontier bitmap;
//   top-down  otherwise: every frontier vertex walks its chunks and
//             claims each neighbour not yet visited.
//
// The level count follows the JAX program's arithmetic: a top-down or
// bottom-up level adds one; the endgame adds one a level it runs, the
// last of which finds nothing, and one more for the empty probe
// (bfs_hybrid_fused.py:366-370), capped at max_levels. A level that finds
// nothing ends the BFS.
//
// What bounds it: bytes. A level gathers 32 bytes of dstT for each chunk
// column it walks, at random columns. `dist` (4n bytes, 268 MB at scale
// 26) does not fit the 50 MB L2; a bitmap of n bits (8 MB) does.
//
// What the design does about it:
//
//   1. Bitmaps in L2 stand for `dist`, which the kernel only writes. `vis`
//      holds the visited vertices, `none` those with no chunk (and the
//      slots past n), and a ring of three frontier bitmaps holds this
//      level's frontier, the next one (built as vertices are found) and
//      one being cleared for the level after, so no level pays a pass to
//      build or clear one.
//   2. A vertex is counted where it is found. A top-down writer claims a
//      neighbour by atomicOr on its `vis` word, and only the thread that
//      saw the bit clear writes `dist`, sets its frontier bit and counts
//      it and its chunks for the next level; a bottom-up vertex has one
//      finder already, the thread, warp or block that walks it. The
//      counts stay in the finders' registers until one atomic a block at
//      the level's end (a shared counter or queue, bumped a find at a
//      time, serialises millions of finds). The unvisited counts come
//      from one pass over `degc` at the start, less what each level finds,
//      so no level passes over n vertices to count.
//   3. No level passes over `dist`: a top-down level takes its frontier
//      from the frontier bitmap and a bottom-up one its candidates from
//      `vis | none`, 32 words a warp at a time, dealing the marked
//      vertices out to the lanes (scan), so a word with none to take
//      costs no round and the endgame needs no list of its own.
//   4. Work goes by degree. Top-down, a warp deals the chunks of its
//      round's vertices of up to kMid chunks out to its lanes, 32 at a
//      time, so no lane idles while another walks a long vertex.
//      Bottom-up, the thread that takes a vertex walks its first kLight
//      chunks, since a vertex mostly finds a parent in its first; the
//      rest of one of up to kMid chunks is appended to a list that a warp
//      a vertex walks, 32 chunks at a time, stopping at the first stride
//      that hits. Past kMid chunks a vertex goes to a list that a block a
//      vertex walks, kThreads chunks at a time, so a hub never holds one
//      thread or warp for its whole degree. Appends and the bitmap words
//      a warp sets are warp-aggregated.
//   5. A thread issues a chunk's 8 dstT loads together before testing any.
//
// Two grid barriers a level. Counts, lists
// and bitmaps change inside the launch, so they are read from L2
// (__ldcg); the read-only cache serves only dstT, colstart and degc,
// which never change. Offsets are 64-bit (lane * Q passes 2^31 at scale
// 26). dist has n + 2 slots; only [0, n) is ever written. A neighbour or
// parent id at or past n (the pad n + 1) is skipped or tests a zero bit.
//
// The split: with a stamp buffer, block 0's first thread records
// %globaltimer after each barrier (see bfs_fused_kernel).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "frontier_words.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kLight = 4;    // chunks the thread that takes it walks
constexpr int32_t kMid = 256;    // chunks a warp walks; past it, a block
constexpr int32_t kGiant = 1 << 14;  // past it, every block, a share each
// the counters of one level, in a ring of 4 (see the kernel): the vertices
// found, their chunks, those of them with a chunk, and the warp, block
// and grid lists' lengths
enum { kF = 0, kM8F, kNZ, kMidN, kHubN, kGiantN, kSlots = 8 };
constexpr int kRing = 4;
constexpr int kUnvis = kRing * kSlots;  // [2]: the first pass's m8u and nu
constexpr int kCounters = kUnvis + 2;
enum { kEndgame = 0, kTopDown = 1, kBottomUp = 2 };

using u64 = unsigned long long;

struct Args {
  int32_t* dist;              // [n + 2]
  const int32_t* dstT;        // [8, Q]
  const int32_t* colstart;    // [n + 1]
  const int32_t* degc;        // [n + 1]
  uint32_t* vis;              // [nwords] bit v: v visited
  uint32_t* none;             // [nwords] bit v: v >= n or degc[v] == 0
  uint32_t* fr;               // [3, nwords] the frontier bitmaps' ring
  int32_t* work;              // [n] warp list from the front, block list
                              // from the back
  int32_t* giant;             // [q / kGiant + 1] the grid list
  u64* ctr;                   // [kCounters], zeroed by the caller
  int32_t* info;              // [2 + mode_cap]: levels, decisions, modes
  u64* stamps;                // [stamp_cap] or nullptr
  int64_t n, Q, nwords, stamp_cap;
  int64_t end_c, end_p, top_f, top_p;
  int32_t source, max_lv, mode_cap;
};

// What one level's walks share: where its finds go.
struct Level {
  int32_t next;               // the level the finds take
  const uint32_t* cur;        // this level's frontier bitmap
  uint32_t* frn;              // the next frontier's bitmap
  u64* slot;                  // the next level's counters
};

__device__ __forceinline__ int64_t warp_id() {
  return (int64_t(blockIdx.x) * kThreads + threadIdx.x) >> 5;
}

__device__ __forceinline__ int64_t warp_count() {
  return (int64_t(gridDim.x) * kThreads) >> 5;
}

__device__ __forceinline__ u64 globaltimer() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Adds k (<= 4) per-thread values into dst[0..k), one atomic a block.
// Every thread of the block must call it.
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

// The rest of a find, once the finder is the only one: dist, and the
// next level's counts in the finder's registers (acc: found, their
// chunks, those with a chunk; a block adds them up once a level). The
// caller has set v's vis and frontier bits.
__device__ __forceinline__ void found_one(const Args& a, const Level& lv,
                                          int32_t v, int32_t dc,
                                          u64 (&acc)[4]) {
  __stcg(a.dist + v, lv.next);
  acc[0] += 1;
  acc[1] += u64(dc);
  acc[2] += dc > 0;
}

// A bottom-up find by its one walker, alone: the bits, then the rest.
__device__ __forceinline__ void claim_found(const Args& a, const Level& lv,
                                            int32_t v, int32_t dc,
                                            u64 (&acc)[4]) {
  const uint32_t bit = 1u << (v & 31);
  atomicOr(a.vis + (v >> 5), bit);
  atomicOr(lv.frn + (v >> 5), bit);
  found_one(a, lv, v, dc, acc);
}

// Bottom-up finds of a whole warp (every lane calls it): lanes whose
// vertices share a bitmap word set their bits with one atomic.
__device__ __forceinline__ void claim_found_warp(const Args& a,
                                                 const Level& lv, bool found,
                                                 int32_t v, int32_t dc,
                                                 u64 (&acc)[4]) {
  if (__ballot_sync(~0u, found) == 0) return;
  const unsigned peers = __match_any_sync(~0u, found ? (v >> 5) : -1);
  const uint32_t bits =
      __reduce_or_sync(peers, found ? 1u << (v & 31) : 0u);
  if (found) {
    if ((threadIdx.x & 31) == __ffs(peers) - 1) {
      atomicOr(a.vis + (v >> 5), bits);
      atomicOr(lv.frn + (v >> 5), bits);
    }
    found_one(a, lv, v, dc, acc);
  }
}

// Top-down: claim every neighbour of chunk column col not yet visited.
// The tests, the claims and the claimed vertices' chunk counts each go out
// together, so a chunk waits for three round trips, not one a neighbour.
__device__ __forceinline__ void expand_chunk(const Args& a, const Level& lv,
                                             int64_t col, u64 (&acc)[4]) {
  int32_t w[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) w[l] = __ldg(a.dstT + l * a.Q + col);
  uint32_t want = 0;                     // neighbours not yet visited
#pragma unroll
  for (int l = 0; l < 8; ++l)
    if (uint32_t(w[l]) < uint64_t(a.n))
      want |= ((~__ldcg(a.vis + (w[l] >> 5)) >> (w[l] & 31)) & 1u) << l;
  if (want == 0u) return;
  uint32_t won = 0;                      // those this thread claimed
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const uint32_t bit = 1u << (w[l] & 31);
    const uint32_t old =
        (want >> l) & 1u ? atomicOr(a.vis + (w[l] >> 5), bit) : bit;
    won |= uint32_t((old & bit) == 0u) << l;
  }
  int32_t dc[8];
#pragma unroll
  for (int l = 0; l < 8; ++l)
    dc[l] = (won >> l) & 1u ? __ldg(a.degc + w[l]) : 0;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    if (!((won >> l) & 1u)) continue;
    atomicOr(lv.frn + (w[l] >> 5), 1u << (w[l] & 31));
    found_one(a, lv, w[l], dc[l], acc);
  }
}

// Bottom-up: does chunk column col hold a parent in this level's
// frontier?
__device__ __forceinline__ bool chunk_hits(const Args& a, const Level& lv,
                                           int64_t col) {
  int32_t par[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) par[l] = __ldg(a.dstT + l * a.Q + col);
  const uint8_t* plane = reinterpret_cast<const uint8_t*>(lv.cur);
  uint32_t any = 0;
#pragma unroll
  for (int l = 0; l < 8; ++l)
    any |= word_of_t<true>(plane, a.nwords * 4, 0, par[l]);
  return any != 0;
}

// The first pass of a level. Each warp loads 32 bitmap words at a time
// (one a lane, 1,024 vertices) and deals the vertices they mark out to
// its lanes, 32 at a time: top-down the frontier, from its bitmap;
// bottom-up (the endgame's levels too) the unvisited with a chunk, the
// clear bits of `vis | none`. So a word with none to take costs no
// round, and every lane of a round has a vertex but in the last. Each
// taken vertex has its first chunks walked here, the rest appended to
// the warp or block list. Every warp runs its loop together.
__device__ void scan(const Args& a, const Level& lv, int mode,
                     u64 (&acc)[4]) {
  const int lane = threadIdx.x & 31;
  for (int64_t w0 = warp_id() * 32; w0 < a.nwords;
       w0 += warp_count() * 32) {
    const int64_t w = w0 + lane;
    uint32_t take = 0;
    if (w < a.nwords)
      take = mode == kTopDown
                 ? __ldcg(lv.cur + w)
                 : ~(__ldcg(a.vis + w) | __ldcg(a.none + w));
    int incl = __popc(take);             // inclusive prefix over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(~0u, incl, 31);
    for (int r = 0; r < total; r += 32) {
      // this lane's vertex: the k-th marked one, in the word of the first
      // lane src whose prefix passes k
      const int k = r + lane;
      int src = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(~0u, incl, src + step - 1) <= k) src += step;
      uint32_t bits = __shfl_sync(~0u, take, src);
      const int before = __shfl_sync(~0u, incl, src) - __popc(bits);
      int32_t v = -1, dc = 0;
      if (k < total) {
        for (int i = before; i < k; ++i) bits &= bits - 1u;
        v = int32_t((w0 + src) * 32 + __ffs(bits) - 1);
        dc = __ldg(a.degc + v);
        if (dc == 0) v = -1;
      }
      const int64_t cs = v >= 0 ? __ldg(a.colstart + v) : 0;
      bool found = false;
      if (mode == kTopDown) {
        // the chunks of the round's vertices of up to kMid chunks, dealt
        // out to the lanes 32 at a time, as the vertices were
        const int32_t mine = v >= 0 && dc <= kMid ? dc : 0;
        int cincl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(~0u, cincl, o);
          if (lane >= o) cincl += t;
        }
        const int ctotal = __shfl_sync(~0u, cincl, 31);
        for (int q = 0; q < ctotal; q += 32) {
          const int kc = q + lane;
          int from = 0;
#pragma unroll
          for (int step = 16; step > 0; step >>= 1)
            if (__shfl_sync(~0u, cincl, from + step - 1) <= kc)
              from += step;
          const int64_t base = __shfl_sync(~0u, cs, from);
          const int skip = __shfl_sync(~0u, cincl, from) -
                           __shfl_sync(~0u, mine, from);
          if (kc < ctotal) expand_chunk(a, lv, base + (kc - skip), acc);
        }
      } else {
        // every vertex's first kLight chunks are walked here, since most
        // finds hit in the first
        if (v >= 0) {
          const int32_t head = dc < kLight ? dc : kLight;
          for (int32_t c = 0; c < head && !found; ++c)
            found = chunk_hits(a, lv, cs + c);
        }
        claim_found_warp(a, lv, found, v, dc, acc);
      }
      // the rest goes to the lists: bottom-up a warp's up to kMid chunks;
      // a block's up to kGiant; past that the grid's
      const bool rest =
          v >= 0 && !found && dc > (mode == kTopDown ? kMid : kLight);
      warp_append(rest && dc <= kMid, v, a.work, lv.slot + kMidN);
      warp_append(rest && dc > kGiant, v, a.giant, lv.slot + kGiantN);
      // the block list fills [n - count, n) from the back
      const unsigned m =
          __ballot_sync(~0u, rest && dc > kMid && dc <= kGiant);
      if (m != 0) {
        const int leader = __ffs(m) - 1;
        u64 base = 0;
        if (lane == leader)
          base = atomicAdd(lv.slot + kHubN, u64(__popc(m)));
        base = __shfl_sync(~0u, base, leader);
        if ((m >> lane) & 1u)
          a.work[a.n - 1 -
                 int64_t(base + __popc(m & ((1u << lane) - 1u)))] = v;
      }
    }
  }
}

// The second pass: the grid list, each vertex's chunks shared out over
// every block (bottom-up each thread stops once the vertex is found, and
// the claim on its `vis` bit picks the one finder); then the block list a
// block a vertex; then the warp list a warp a vertex; bottom-up from the
// chunk past those scan walked.
__device__ void walk_lists(const Args& a, const Level& lv, int mode,
                           u64 (&acc)[4]) {
  const int64_t ngiant = int64_t(__ldcg(lv.slot + kGiantN));
  const int64_t nhub = int64_t(__ldcg(lv.slot + kHubN));
  const int64_t nmid = int64_t(__ldcg(lv.slot + kMidN));
  const int32_t first = mode == kTopDown ? 0 : kLight;  // scan's share
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t i = 0; i < ngiant; ++i) {
    const int32_t v = __ldcg(a.giant + i);
    const int64_t cs = __ldg(a.colstart + v);
    const int32_t dc = __ldg(a.degc + v);
    const uint32_t bit = 1u << (v & 31);
    for (int64_t c = first + int64_t(blockIdx.x) * kThreads + threadIdx.x;
         c < dc; c += stride) {
      if (mode == kTopDown) {
        expand_chunk(a, lv, cs + c, acc);
      } else {
        if ((__ldcg(a.vis + (v >> 5)) & bit) != 0u) break;
        if (chunk_hits(a, lv, cs + c)) {
          if (!(atomicOr(a.vis + (v >> 5), bit) & bit)) {
            atomicOr(lv.frn + (v >> 5), bit);
            found_one(a, lv, v, dc, acc);
          }
          break;
        }
      }
    }
  }
  for (int64_t i = blockIdx.x; i < nhub; i += gridDim.x) {
    const int32_t v = __ldcg(a.work + a.n - 1 - i);
    const int64_t cs = __ldg(a.colstart + v);
    const int32_t dc = __ldg(a.degc + v);
    if (mode == kTopDown) {
      for (int32_t c = threadIdx.x; c < dc; c += kThreads)
        expand_chunk(a, lv, cs + c, acc);
    } else {
      for (int32_t c0 = first; c0 < dc; c0 += kThreads) {
        const int32_t c = c0 + threadIdx.x;
        if (__syncthreads_or(c < dc && chunk_hits(a, lv, cs + c))) {
          if (threadIdx.x == 0) claim_found(a, lv, v, dc, acc);
          break;
        }
      }
    }
  }
  const int lane = threadIdx.x & 31;
  for (int64_t i = warp_id(); i < nmid; i += warp_count()) {
    const int32_t v = __ldcg(a.work + i);
    const int64_t cs = __ldg(a.colstart + v);
    const int32_t dc = __ldg(a.degc + v);
    if (mode == kTopDown) {
      for (int32_t c = lane; c < dc; c += 32)
        expand_chunk(a, lv, cs + c, acc);
    } else {
      for (int32_t c0 = first; c0 < dc; c0 += 32) {
        const int32_t c = c0 + lane;
        if (__any_sync(~0u, c < dc && chunk_hits(a, lv, cs + c))) {
          if (lane == 0) claim_found(a, lv, v, dc, acc);
          break;
        }
      }
    }
  }
}

// The first pass: `none`, the source's bits, level 0's counts (the
// source) and the unvisited counts.
__device__ void first_pass(const Args& a) {
  u64 acc[4] = {0, 0, 0, 0};
  const int lane = threadIdx.x & 31;
  constexpr int kWords = 4;              // a warp's words in flight at once
  for (int64_t w0 = warp_id() * kWords; w0 < a.nwords;
       w0 += warp_count() * kWords) {
    int32_t dc[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const int64_t v = (w0 + q) * 32 + lane;
      dc[q] = v < a.n ? __ldg(a.degc + v) : 0;
    }
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      if ((w0 + q) * 32 + lane != a.source) {
        acc[0] += u64(dc[q]);
        acc[1] += dc[q] > 0;
      }
      const unsigned bits = __ballot_sync(~0u, dc[q] == 0);
      if (lane == 0 && w0 + q < a.nwords) __stcg(a.none + w0 + q, bits);
    }
  }
  block_add(a.ctr + kUnvis, acc, 2);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const uint32_t bit = 1u << (a.source & 31);
    a.vis[a.source >> 5] = bit;
    a.fr[a.source >> 5] = bit;
    a.ctr[kF] = 1;
    a.ctr[kM8F] = u64(__ldg(a.degc + a.source));
  }
}

// The whole BFS. Level e's counts sit in ring slot e % 4, and level e
// fills slot (e + 1) % 4. At its top the first thread zeroes slot
// (e + 2) % 4, which level e + 1 fills; that slot is (e - 2) % 4, last
// read at the top of level e - 2 (as its counts), four barriers earlier,
// so no thread still reads a slot that is being zeroed. Frontier bitmap
// e % 3 is level e's; level e sets (e + 1) % 3 and clears (e + 2) % 3,
// which level e - 1 read and level e + 1 sets, each a barrier away.
//
// The split: stamps[1] at the start, [2] after the first pass, then three
// a level e from [3 + 3e]: at its top (after the decision and the
// clearing), after scan and after walk_lists; stamps[0] the levels
// stamped.
__global__ void __launch_bounds__(kThreads) bfs_fused_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  const bool boss = blockIdx.x == 0 && threadIdx.x == 0;
  auto stamp = [&](int64_t i, u64 t) {
    if (boss && a.stamps != nullptr && i < a.stamp_cap) a.stamps[i] = t;
  };
  stamp(1, globaltimer());
  first_pass(a);
  grid.sync();
  stamp(2, globaltimer());
  int64_t m8u = int64_t(__ldcg(a.ctr + kUnvis));
  int64_t nu = int64_t(__ldcg(a.ctr + kUnvis + 1));
  int32_t level = 0, levels = 0, nrec = 0;
  bool endgame = false;
  for (int64_t e = 0;; ++e) {
    const u64* st = a.ctr + (e % kRing) * kSlots;
    const int64_t f = int64_t(__ldcg(st + kF));
    const int64_t m8f = int64_t(__ldcg(st + kM8F));
    if (e > 0) {                 // what the last level found is visited
      m8u -= m8f;
      nu -= int64_t(__ldcg(st + kNZ));
    }
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
    const Level lv{level + 1, a.fr + (e % 3) * a.nwords,
                   a.fr + ((e + 1) % 3) * a.nwords,
                   a.ctr + ((e + 1) % kRing) * kSlots};
    if (boss) {
      u64* z = a.ctr + ((e + 2) % kRing) * kSlots;
      for (int k = 0; k < kSlots; ++k) z[k] = 0;
    }
    uint32_t* clear = a.fr + ((e + 2) % 3) * a.nwords;
    for (int64_t w = int64_t(blockIdx.x) * kThreads + threadIdx.x;
         w < a.nwords; w += int64_t(gridDim.x) * kThreads)
      __stcg(clear + w, 0u);
    // the endgame's levels are bottom-up levels until one finds nothing
    if (mode == kEndgame) endgame = true;
    stamp(3 + 3 * e, globaltimer());
    u64 acc[4] = {0, 0, 0, 0};
    const int work = mode == kTopDown ? kTopDown : kBottomUp;
    scan(a, lv, work, acc);
    grid.sync();
    stamp(4 + 3 * e, globaltimer());
    walk_lists(a, lv, work, acc);
    block_add(lv.slot + kF, acc, 3);
    grid.sync();
    stamp(5 + 3 * e, globaltimer());
    ++level;
  }
  if (boss) {
    a.info[0] = levels;
    a.info[1] = nrec;
    if (a.stamps != nullptr && a.stamp_cap > 0) a.stamps[0] = u64(level);
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
int tt_bfs_fused_counters() { return kCounters; }

// The chunks past which a vertex is walked by every block: the grid list
// holds at most Q / tt_bfs_fused_giant() vertices.
int tt_bfs_fused_giant() { return kGiant; }

// The blocks of one launch on the current device, or a negative
// cudaError_t.
int tt_bfs_fused_grid() {
  int blocks;
  const cudaError_t e = resident_blocks(&blocks);
  return e == cudaSuccess ? blocks : -int(e);
}

// Enqueues the BFS on `stream` (one cooperative launch); returns its
// cudaError_t. dist: [n + 2], INF but the source's 0 (written, never
// read); bits: [5, nwords] zeros (vis, none, the frontier ring); work:
// [n] scratch (the warp and block lists); giant: [Q / tt_bfs_fused_giant()
// + 1] scratch (the grid list); ctr: [tt_bfs_fused_counters()]
// zeros; info: [2 + mode_cap]; stamps: [stamp_cap] %globaltimer readings
// (the kernel's note), or nullptr for none.
int tt_bfs_fused(int32_t* dist, const int32_t* dstT, const int32_t* colstart,
                 const int32_t* degc, uint32_t* bits, int32_t* work,
                 int32_t* giant,
                 unsigned long long* ctr, int32_t* info,
                 unsigned long long* stamps, int64_t n, int64_t Q,
                 int64_t nwords, int64_t source, int64_t end_c,
                 int64_t end_p, int64_t top_f, int64_t top_p, int max_lv,
                 int mode_cap, int64_t stamp_cap, void* stream) {
  if (n < 1 || n >= (int64_t(1) << 31) - 2 || Q < 1 ||
      nwords * 32 < n + 2 || source < 0 || source >= n || mode_cap < 0 ||
      (stamps != nullptr && stamp_cap < 1))
    return cudaErrorInvalidValue;
  int blocks;
  const cudaError_t e = resident_blocks(&blocks);
  if (e != cudaSuccess) return e;
  Args a{dist, dstT, colstart, degc, bits, bits + nwords, bits + 2 * nwords,
         work, giant, ctr, info, stamps, n, Q, nwords, stamp_cap,
         end_c, end_p, top_f, top_p, int32_t(source), max_lv, mode_cap};
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(bfs_fused_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
