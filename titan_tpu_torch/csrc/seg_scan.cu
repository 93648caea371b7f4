// seg_scan: inclusive segmented scan (sum, min or max) over the
// dst-sorted edge axis of the vertex-program engine, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_seg_scan_kernel` (titan_tpu/ops/
// pallas_segment.py:41, launched by `pallas_seg_scan`). It computes what
// that kernel computes (see titan_tpu_torch/ops/seg_scan.py for the
// contract and `seg_scan_reference` for the plain version): out[i] is the
// combine of values[s..i], where s is the last segment start at or before
// i; flags[i] != 0 marks a start and index 0 always starts a segment.
//
// What bounds it: bytes. Each value (4 B) and flag (1 B) is read once and
// each output (4 B) written once, 9 bytes an element: 1.15 GB at
// E = 1.28e8, 0.34 ms at 3.35 TB/s. The scan does a handful of integer
// and float operations an element, far below the card's rates.
//
// What the design does about it: one pass, one launch. The TPU kernel
// walks the edge axis in a grid that runs in order and carries the
// straddling segment's value in an SMEM scalar; CUDA blocks run in no
// order, so the carry between tiles goes through device memory by
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA 2016):
//
//   1. Persistent blocks, as many as fit on the card at once, take tiles
//      from an atomic ticket, so every tile a block waits for is held by
//      a block that is running and reaches it: the look-back always ends
//      (forward progress without relying on the order in which blocks
//      are dispatched).
//   2. Each block keeps a ring of kStages tiles in shared memory and
//      copies its tiles into it with cp.async (16 bytes a thread,
//      neighbouring threads on neighbouring chunks, one group a tile),
//      kStages - 2 tiles ahead, so the loads stay in flight while it
//      scans. Each thread reads its kItems consecutive elements from the
//      stage (values as uint4, 16 flags a uint4) and folds them; a
//      warp-shuffle scan and a scan of the warp totals give the tile's
//      aggregate.
//   3. The tile publishes a 64-bit status word: the state (aggregate or
//      inclusive prefix), whether the tile holds a start, and the 32-bit
//      value, in one store with release semantics. A tile that holds a
//      start publishes its inclusive prefix at once: its suffix after its
//      last start does not depend on the carry.
//   4. The look-back waits one round: in round i a block reduces and
//      publishes its tile i, and only then finishes its tile i - 1. Warp
//      0 looks back over the statuses of the tiles before it, 32 at a
//      time, read with acquire semantics, for the carry; a tile without a
//      start then publishes its inclusive prefix. By then its
//      predecessors have had a round to publish, so the walk seldom spins
//      on a status not yet published, as it does when the look-back comes
//      right after the reduce.
//   5. Each thread re-folds its elements from its exclusive prefix and
//      writes them back into the stage, from which the block stores the
//      tile with coalesced 16-byte stores.
//
// The segmented operator is (v, f) . (w, g) = (g ? w : v op w, f | g),
// which is associative, so the tree of partial combines inside a tile
// gives the sequential result.
//
// Bit-equal run to run. Inside a tile the order of every combine is fixed
// by the tile shape. Across tiles, let A_j be tile j's aggregate and s the
// last tile at or before t - 1 that holds a start (tile 0 always does).
// The carry into tile t is always the LEFT fold
//     C_t = ((A_s . A_{s+1}) . ...) . A_{t-1},
// and the prefix a tile publishes is P_j = C_j . A_j, the same left fold
// one tile further (P_s = A_s). A look-back that finds a published prefix
// at tile j >= s continues it as ((P_j . A_{j+1}) . ...) . A_{t-1},
// folded from its left end, which is the same sequence of operations as
// the fold from s, so it gives the same bits wherever the walk stops;
// and a status read again later that has turned from aggregate into
// prefix restarts the fold from that prefix, again the same bits. A
// CUB-style look-back that folds the aggregates right to left as it walks
// (P_j . (A_{j+1} . (... . A_{t-1}))) would add floats in an order that
// depends on which predecessors had published their prefix. The ticket is
// an integer atomic on one counter and orders no float addition.
//
// The statuses and the ticket live in a scratch array of
// ceil(n / kTile) + 1 64-bit words that the wrapper zeroes before every
// call, so no call reads a status of an earlier one. Integer sums wrap
// (two's complement), as the plain version's do. Offsets are int64; the
// wrapper raises at E >= 2^31 (the engine's last-index gather is int32).
// The last tile, and inputs not aligned to 16 bytes, are staged and
// written element by element with masks, the padding holding the
// identity.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // consecutive elements a thread
constexpr int kTile = kThreads * kItems;   // elements a tile
// tiles staged in shared memory a block: one finishing, one reducing,
// the other in flight
constexpr int kStages = 3;
constexpr int kAhead = kStages - 2;
static_assert(kThreads % 32 == 0 && kWarps <= 32, "1-32 whole warps");
static_assert(kItems % 16 == 0, "16 flags a 16-byte load");
static_assert(kStages >= 3, "a finishing, a reducing and a loading tile");

// status word: the state in the high 32 bits, the value's bits in the low
constexpr uint32_t kInvalid = 0;     // not published yet (zeroed scratch)
constexpr uint32_t kAggregate = 1;   // the tile's own aggregate
constexpr uint32_t kPrefix = 2;      // the inclusive prefix through the tile
constexpr uint32_t kStateMask = 3;
constexpr uint32_t kHasStart = 4;    // the tile holds a segment start

template <class T>
struct Lim;
template <>
struct Lim<float> {
  static __device__ __forceinline__ float hi() { return CUDART_INF_F; }
  static __device__ __forceinline__ float lo() { return -CUDART_INF_F; }
  static __device__ __forceinline__ uint32_t bits(float v) {
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ float of(uint32_t b) {
    return __uint_as_float(b);
  }
};
template <>
struct Lim<int32_t> {
  static __device__ __forceinline__ int32_t hi() { return 2147483647; }
  static __device__ __forceinline__ int32_t lo() { return -2147483647 - 1; }
  static __device__ __forceinline__ uint32_t bits(int32_t v) {
    return (uint32_t)v;
  }
  static __device__ __forceinline__ int32_t of(uint32_t b) {
    return (int32_t)b;
  }
};

struct Sum {
  template <class T>
  static __device__ __forceinline__ T ident() { return T(0); }
  static __device__ __forceinline__ float op(float a, float b) { return a + b; }
  static __device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);  // wraps, never UB
  }
};
struct Min {
  template <class T>
  static __device__ __forceinline__ T ident() { return Lim<T>::hi(); }
  template <class T>
  static __device__ __forceinline__ T op(T a, T b) { return b < a ? b : a; }
};
struct Max {
  template <class T>
  static __device__ __forceinline__ T ident() { return Lim<T>::lo(); }
  template <class T>
  static __device__ __forceinline__ T op(T a, T b) { return b > a ? b : a; }
};

// (v, f) <- (v, f) . (w, g)
template <class T, class Op>
__device__ __forceinline__ void fold(T& v, int& f, T w, int g) {
  v = g ? w : Op::op(v, w);
  f |= g;
}

__device__ __forceinline__ uint64_t status_word(uint32_t state,
                                                uint32_t bits) {
  return (uint64_t(state) << 32) | bits;
}
__device__ __forceinline__ uint32_t state_of(uint64_t w) {
  return uint32_t(w >> 32) & kStateMask;
}
__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}
// index of the highest set bit, -1 for none
__device__ __forceinline__ int msb(unsigned m) { return 31 - __clz(m); }

// flag of item r among the thread's kItems (4 flag bytes a word)
__device__ __forceinline__ int flag_of(const uint32_t* fw, int r) {
  return ((fw[r >> 2] >> (8 * (r & 3))) & 0xffu) != 0;
}

// The carry into `tile` (> 0), by one whole warp; every lane returns it.
// Walks back over windows of 32 statuses ending at `end` until a window
// holds a prefix with nothing unpublished after it, then folds from that
// prefix to tile - 1 left to right (see the note at the top).
template <class T, class Op>
__device__ T look_back(const uint64_t* status, int64_t tile) {
  const int lane = threadIdx.x & 31;
  int64_t end = tile;
  uint64_t w;
  int p;
  for (;;) {
    const int64_t i = end - 32 + lane;
    // before tile 0 nothing is read; tile 0 always publishes a prefix,
    // so these lanes lie below the one the walk stops at
    w = i >= 0 ? ld_acquire(status + i) : status_word(kAggregate, 0);
    const uint32_t s = state_of(w);
    const unsigned pre = __ballot_sync(~0u, s == kPrefix);
    const unsigned inv = __ballot_sync(~0u, s == kInvalid);
    p = msb(pre);
    if (p > msb(inv)) break;        // a prefix, all after it published
    if (inv == 0) end -= 32;        // 32 aggregates: one window further
  }                                 // else wait for the window again
  const T v = Lim<T>::of(uint32_t(w));
  T acc = __shfl_sync(~0u, v, p);
  for (int k = p + 1; k < 32; ++k) acc = Op::op(acc, __shfl_sync(~0u, v, k));
  // the windows walked past, oldest first: all published, maybe some
  // turned into prefixes since; the newest prefix restarts the fold
  for (int64_t b = end; b < tile; b += 32) {
    const int64_t i = b + lane;
    const bool in = i < tile;
    const uint64_t wi = in ? ld_acquire(status + i) : 0;
    const T vi = Lim<T>::of(uint32_t(wi));
    const unsigned pre = __ballot_sync(~0u, in && state_of(wi) == kPrefix);
    int k = 0;
    if (pre) {
      k = msb(pre);
      acc = __shfl_sync(~0u, vi, k);
      ++k;
    }
    const int m = tile - b < 32 ? int(tile - b) : 32;
    for (; k < m; ++k) acc = Op::op(acc, __shfl_sync(~0u, vi, k));
  }
  return acc;
}

// 16-byte chunks of values and of flags a tile
constexpr int kValueChunks = kTile / 4;
constexpr int kFlagChunks = kTile / 16;

// One tile staged in shared memory. Value chunk c lies at swizzled(c):
// the copies (a quarter-warp writes 8 consecutive chunks) and each
// thread's reads of its own kItems / 4 chunks are free of bank conflicts.
struct Stage {
  uint4 v[kValueChunks];
  uint4 f[kFlagChunks];
};
__device__ __forceinline__ int swizzled(int c) { return c ^ ((c >> 3) & 7); }

template <class T>
struct Block {
  T wv[2][kWarps];           // warp totals, scanned: [0] reduce, [1] finish
  int wf[2][kWarps];
  T carry;                   // the carry into the finishing tile
  unsigned tile[kStages];    // the tile in each stage
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// waits until at most kAhead groups of this thread's copies are pending
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kAhead) : "memory");
}

// Starts copying tile `tile` into `st` as one cp.async group: 16-byte
// copies of whole chunks inside [0, n) when the inputs are aligned, else
// element by element, with the identity and no start past n.
template <class T, class Op>
__device__ void stage_tile(Stage& st, const T* __restrict__ vals,
                           const uint8_t* __restrict__ flags, int64_t n,
                           int64_t tile, bool aligned) {
  const int tid = threadIdx.x;
  const int64_t base = tile * kTile;
#pragma unroll
  for (int j = 0; j < kValueChunks / kThreads; ++j) {
    const int c = j * kThreads + tid;
    const int64_t g = base + 4 * int64_t(c);
    if (aligned && g + 4 <= n) {
      cp_async16(&st.v[swizzled(c)], vals + g);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = Lim<T>::bits(g + k < n ? vals[g + k]
                                      : Op::template ident<T>());
      st.v[swizzled(c)] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < kFlagChunks / kThreads; ++j) {
    const int c = j * kThreads + tid;
    const int64_t g = base + 16 * int64_t(c);
    if (aligned && g + 16 <= n) {
      cp_async16(&st.f[c], flags + g);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (g + k < n)
          w[k >> 2] |= uint32_t(flags[g + k] != 0) << (8 * (k & 3));
      st.f[c] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  cp_async_commit();
}

// Scans the staged tile. Reduce (Finish false): publishes the tile's
// aggregate, or its prefix if it holds a start. Finish: scans it again,
// looks back for its carry, publishes its prefix if it holds no start and
// writes `out`. The two give the same aggregate bits.
template <class T, class Op, bool Finish>
__device__ void scan_tile(Stage& st, int64_t tile, int64_t n,
                          T* __restrict__ out, uint64_t* __restrict__ status,
                          bool aligned, Block<T>& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T ident = Op::template ident<T>();
  const int64_t base = tile * kTile;
  const int64_t first = base + int64_t(tid) * kItems;
  T* swv = sh.wv[Finish];
  int* swf = sh.wf[Finish];

  T x[kItems];
  uint32_t fw[kItems / 4];
#pragma unroll
  for (int q = 0; q < kItems / 4; ++q) {
    const uint4 u = st.v[swizzled(tid * (kItems / 4) + q)];
    x[4 * q] = Lim<T>::of(u.x);
    x[4 * q + 1] = Lim<T>::of(u.y);
    x[4 * q + 2] = Lim<T>::of(u.z);
    x[4 * q + 3] = Lim<T>::of(u.w);
  }
#pragma unroll
  for (int q = 0; q < kItems / 16; ++q) {
    const uint4 u = st.f[tid * (kItems / 16) + q];
    fw[4 * q] = u.x;
    fw[4 * q + 1] = u.y;
    fw[4 * q + 2] = u.z;
    fw[4 * q + 3] = u.w;
  }
  if (first == 0) fw[0] |= 1u;  // index 0 always starts a segment

  // the thread's aggregate, then the inclusive scan of them in the warp
  T sv = ident;
  int sf = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) fold<T, Op>(sv, sf, x[r], flag_of(fw, r));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T pv = __shfl_up_sync(~0u, sv, d);
    const int pf = __shfl_up_sync(~0u, sf, d);
    if (lane >= d) {
      T v = pv;
      int f = pf;
      fold<T, Op>(v, f, sv, sf);
      sv = v;
      sf = f;
    }
  }
  if (lane == 31) {
    swv[warp] = sv;
    swf[warp] = sf;
  }
  __syncthreads();
  if (warp == 0) {
    // inclusive scan of the warp totals; the last is the tile's aggregate
    T wv = lane < kWarps ? swv[lane] : ident;
    int wf = lane < kWarps ? swf[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const T pv = __shfl_up_sync(~0u, wv, d);
      const int pf = __shfl_up_sync(~0u, wf, d);
      if (lane >= d) {
        T v = pv;
        int f = pf;
        fold<T, Op>(v, f, wv, wf);
        wv = v;
        wf = f;
      }
    }
    const T tv = __shfl_sync(~0u, wv, kWarps - 1);
    const int tf = __shfl_sync(~0u, wf, kWarps - 1);
    if (!Finish) {
      if (lane == 0)
        st_release(status + tile,
                   status_word(tf ? kPrefix | kHasStart : kAggregate,
                               Lim<T>::bits(tv)));
      return;
    }
    const T carry = tile > 0 ? look_back<T, Op>(status, tile) : ident;
    if (lane == 0) {
      sh.carry = carry;
      if (!tf)
        st_release(status + tile,
                   status_word(kPrefix, Lim<T>::bits(Op::op(carry, tv))));
    }
    if (lane < kWarps) {
      swv[lane] = wv;
      swf[lane] = wf;
    }
  }
  if (!Finish) return;
  __syncthreads();

  // exclusive prefix of this thread: carry, earlier warps, earlier lanes
  T pv = sh.carry;
  int pf = 0;
  if (warp > 0) fold<T, Op>(pv, pf, swv[warp - 1], swf[warp - 1]);
  const T lv = __shfl_up_sync(~0u, sv, 1);
  const int lf = __shfl_up_sync(~0u, sf, 1);
  if (lane > 0) fold<T, Op>(pv, pf, lv, lf);
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    fold<T, Op>(pv, pf, x[r], flag_of(fw, r));
    x[r] = pv;
  }
  if (aligned && base + kTile <= n) {
    // back through the stage, so that the stores are coalesced
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q)
      st.v[swizzled(tid * (kItems / 4) + q)] = make_uint4(
          Lim<T>::bits(x[4 * q]), Lim<T>::bits(x[4 * q + 1]),
          Lim<T>::bits(x[4 * q + 2]), Lim<T>::bits(x[4 * q + 3]));
    __syncthreads();
    uint4* o = reinterpret_cast<uint4*>(out + base);
#pragma unroll
    for (int j = 0; j < kValueChunks / kThreads; ++j) {
      const int c = j * kThreads + tid;
      o[c] = st.v[swizzled(c)];
    }
  } else {
#pragma unroll
    for (int r = 0; r < kItems; ++r)
      if (first + r < n) out[first + r] = x[r];
  }
}

// Persistent: each block takes tiles by ticket into a ring of kStages
// stages. In round i it starts copying its tile i + kAhead, reduces tile
// i (publishing its aggregate) and then finishes tile i - 1: by then the
// tiles before i - 1 have had a whole round to publish, so the look-back
// seldom waits.
template <class T, class Op>
__global__ void __launch_bounds__(kThreads)
seg_scan_kernel(const T* __restrict__ vals, const uint8_t* __restrict__ flags,
                int64_t n, T* __restrict__ out, uint64_t* __restrict__ status,
                unsigned* __restrict__ ticket, bool aligned) {
  extern __shared__ uint4 dyn[];
  Stage* stage = reinterpret_cast<Stage*>(dyn);
  __shared__ Block<T> sh;
  const int tid = threadIdx.x;
  const int64_t ntiles = (n + kTile - 1) / kTile;
  if (tid == 0)
    for (int j = 0; j < kAhead; ++j) sh.tile[j] = atomicAdd(ticket, 1u);
  __syncthreads();
  if (sh.tile[0] >= ntiles) return;
  for (int j = 0; j < kAhead; ++j) {
    if (sh.tile[j] < ntiles)
      stage_tile<T, Op>(stage[j], vals, flags, n, sh.tile[j], aligned);
    else
      cp_async_commit();  // an empty group keeps the count
  }
  unsigned ahead = tid == 0 ? atomicAdd(ticket, 1u) : 0u;
  for (int i = 0;; ++i) {
    const int cur = i % kStages, prev = (i + kStages - 1) % kStages;
    const int load = (i + kAhead) % kStages;  // the stage finished last round
    __syncthreads();  // sh.tile read, stage `load` no longer read
    if (tid == 0) sh.tile[load] = ahead;
    __syncthreads();
    const int64_t next = sh.tile[load];
    if (next < ntiles) {
      stage_tile<T, Op>(stage[load], vals, flags, n, next, aligned);
      if (tid == 0) ahead = atomicAdd(ticket, 1u);  // staged next round
    } else {
      cp_async_commit();
    }
    cp_async_wait_ahead();  // this thread's copies of tile i have landed
    __syncthreads();        // and every thread's
    const int64_t tile = sh.tile[cur];
    if (tile < ntiles)
      scan_tile<T, Op, false>(stage[cur], tile, n, out, status, aligned, sh);
    if (i > 0)
      scan_tile<T, Op, true>(stage[prev], sh.tile[prev], n, out, status,
                             aligned, sh);
    if (tile >= ntiles) return;
  }
}

constexpr int kSmem = kStages * sizeof(Stage);
constexpr int kMaxDevices = 64;

// The blocks of seg_scan_kernel<T, Op> that fit on the current device at
// once. The shared-memory attribute and the occupancy query run at the
// first call on each device; later calls read the cached count.
template <class T, class Op>
cudaError_t resident_blocks(int* blocks) {
  static std::atomic<int> cached[kMaxDevices];  // 0: not worked out yet
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*blocks = cached[dev].load()) > 0)
    return cudaSuccess;
  auto* kernel = seg_scan_kernel<T, Op>;
  int sms, per_sm;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, kSmem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) cached[dev].store(*blocks);
  return cudaSuccess;
}

template <class T, class Op>
int launch(const void* vals, const uint8_t* flags, int64_t n, void* out,
           uint64_t* scratch, cudaStream_t st) {
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const bool aligned = ((reinterpret_cast<uintptr_t>(vals) |
                         reinterpret_cast<uintptr_t>(flags) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  int resident;
  const cudaError_t e = resident_blocks<T, Op>(&resident);
  if (e != cudaSuccess) return e;
  // the blocks that fit on the card at once, no more than the tiles
  const int64_t grid = ntiles < resident ? ntiles : resident;
  seg_scan_kernel<T, Op><<<(unsigned)grid, kThreads, kSmem, st>>>(
      static_cast<const T*>(vals), flags, n, static_cast<T*>(out), scratch,
      reinterpret_cast<unsigned*>(scratch + ntiles), aligned);
  return cudaGetLastError();
}

template <class T>
int launch_combine(int combine, const void* vals, const uint8_t* flags,
                   int64_t n, void* out, uint64_t* scratch, cudaStream_t st) {
  switch (combine) {
    case 0:
      return launch<T, Sum>(vals, flags, n, out, scratch, st);
    case 1:
      return launch<T, Min>(vals, flags, n, out, scratch, st);
    case 2:
      return launch<T, Max>(vals, flags, n, out, scratch, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int tt_seg_scan_tile(void) { return kTile; }

// Enqueues the scan on `stream` (one launch); returns its cudaError_t.
// dtype: 0 float32, 1 int32. combine: 0 sum, 1 min, 2 max.
// Scratch: ceil(n / tt_seg_scan_tile()) + 1 64-bit words, zeroed before
// every call (the tile statuses, then the ticket counter).
int tt_seg_scan(int dtype, int combine, const void* vals, const uint8_t* flags,
                int64_t n, void* out, void* scratch, void* stream) {
  if (n < 0 || n >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* sc = static_cast<uint64_t*>(scratch);
  switch (dtype) {
    case 0:
      return launch_combine<float>(combine, vals, flags, n, out, sc, st);
    case 1:
      return launch_combine<int32_t>(combine, vals, flags, n, out, sc, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
