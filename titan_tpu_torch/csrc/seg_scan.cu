// seg_scan: inclusive segmented scan (sum, min or max) over the
// dst-sorted edge axis of the vertex-program engine, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_seg_scan_kernel` launched by
// `pallas_seg_scan` in titan_tpu/ops/pallas_segment.py. It computes what
// that kernel computes (see titan_tpu_torch/ops/seg_scan.py for the
// contract and `seg_scan_reference` for the plain version): out[i] is the
// combine of values[s..i], where s is the last segment start at or before
// i; flags[i] != 0 marks a start and index 0 always starts a segment.
// The TPU kernel walks the edge axis in a grid that runs in order and
// carries the straddling segment's value in an SMEM scalar. CUDA blocks
// run in no order, so the carry is a second pass: reduce-then-scan, three
// launches on one stream, over tiles of kTile elements:
//
//   A. tile_reduce: one block per tile. The tile's segmented aggregate:
//      whether it holds a start, and the combine of its suffix from its
//      last start (the whole tile if it holds none).
//   B. carry_scan: one block. A segmented inclusive scan of the tile
//      aggregates, in chunks of kTile with a running carry; the result at
//      tile t is written as the carry-in of tile t + 1 (identity for
//      tile 0).
//   C. tile_scan: one block per tile. The scan inside the tile, started
//      from the tile's carry-in, so positions before the tile's first
//      start continue the segment carried in; `out` is written.
//
// Inside a tile (scan_tile): a coalesced load into shared memory, 16
// consecutive elements per thread folded in registers, a warp-shuffle
// scan of the thread aggregates, a scan of the warp totals in shared
// memory, then each thread re-folds its elements from its exclusive
// prefix and the tile is stored coalesced. The segmented operator is
// (v, f) . (w, g) = (g ? w : v op w, f | g), which is associative, so the
// tree of partial combines gives the sequential result.
//
// No atomics: the order of every float sum is fixed by the tile shape, so
// two runs on the card are bit-equal. Integer sums wrap (two's
// complement), as the plain version's do. Offsets are int64; the wrapper
// raises at E >= 2^31 (the engine's last-index gather is int32).
//
// What bounds it: bytes. Reading values and flags once and writing out
// once is 9 bytes an element with 4-byte values and 1-byte flags (1.1 GB
// at E = 1.2e8, about 0.33 ms at 3.35 TB/s). This version reads values
// and flags twice (A and C), 14 bytes an element. Left for later:
// decoupled look-back (one pass), fusing the engine's last-index gather,
// and TMA staging.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // consecutive elements per thread
constexpr int kTile = kThreads * kItems;   // 4096 elements per tile

template <class T>
struct Lim;
template <>
struct Lim<float> {
  static __device__ __forceinline__ float hi() { return CUDART_INF_F; }
  static __device__ __forceinline__ float lo() { return -CUDART_INF_F; }
};
template <>
struct Lim<int32_t> {
  static __device__ __forceinline__ int32_t hi() { return 2147483647; }
  static __device__ __forceinline__ int32_t lo() { return -2147483647 - 1; }
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

// tile index -> shared-memory word, one pad word per 32: the coalesced
// accesses (consecutive i) and the per-thread runs (stride kItems) are
// both free of bank conflicts
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

template <class T>
struct Smem {
  T v[kTile + kTile / 32];
  alignas(16) uint8_t f[kTile];
  T wv[kWarps];
  int wf[kWarps];
};

// Scans the tile of elements [base, min(base + kTile, n)) from the
// carry-in (cv, cf) and returns the combine of the carry and the whole
// tile in (cv, cf). With `out`, writes the inclusive result of element
// base + i to out[base + i + shift] where that index is below n_out.
template <class T, class Op>
__device__ void scan_tile(const T* __restrict__ vals,
                          const uint8_t* __restrict__ flags, int64_t base,
                          int64_t n, T& cv, int& cf, T* __restrict__ out,
                          int64_t shift, int64_t n_out, Smem<T>& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T ident = Op::template ident<T>();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {  // coalesced load
    const int i = r * kThreads + tid;
    const int64_t g = base + i;
    const bool in = g < n;
    sm.v[padded(i)] = in ? vals[g] : ident;
    sm.f[i] = in && (g == 0 || flags[g] != 0);
  }
  __syncthreads();
  T x[kItems];
  int fl[kItems];
  const uint4 fw = *reinterpret_cast<const uint4*>(&sm.f[tid * kItems]);
  const uint32_t words[4] = {fw.x, fw.y, fw.z, fw.w};
  T av = ident;
  int af = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    x[r] = sm.v[padded(tid * kItems + r)];
    fl[r] = (words[r >> 2] >> (8 * (r & 3))) & 0xff;
    fold<T, Op>(av, af, x[r], fl[r]);
  }
  // inclusive scan of the thread aggregates inside the warp
  T sv = av;
  int sf = af;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T pv = __shfl_up_sync(0xffffffffu, sv, d);
    const int pf = __shfl_up_sync(0xffffffffu, sf, d);
    if (lane >= d) {
      T v = pv;
      int f = pf;
      fold<T, Op>(v, f, sv, sf);
      sv = v;
      sf = f;
    }
  }
  if (lane == 31) {
    sm.wv[warp] = sv;
    sm.wf[warp] = sf;
  }
  __syncthreads();
  if (warp == 0) {  // inclusive scan of the warp totals
    T wv = lane < kWarps ? sm.wv[lane] : ident;
    int wf = lane < kWarps ? sm.wf[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const T pv = __shfl_up_sync(0xffffffffu, wv, d);
      const int pf = __shfl_up_sync(0xffffffffu, wf, d);
      if (lane >= d) {
        T v = pv;
        int f = pf;
        fold<T, Op>(v, f, wv, wf);
        wv = v;
        wf = f;
      }
    }
    if (lane < kWarps) {
      sm.wv[lane] = wv;
      sm.wf[lane] = wf;
    }
  }
  __syncthreads();
  // exclusive prefix of this thread: carry, earlier warps, earlier lanes
  T pv = cv;
  int pf = cf;
  if (warp > 0) fold<T, Op>(pv, pf, sm.wv[warp - 1], sm.wf[warp - 1]);
  const T lv = __shfl_up_sync(0xffffffffu, sv, 1);
  const int lf = __shfl_up_sync(0xffffffffu, sf, 1);
  if (lane > 0) fold<T, Op>(pv, pf, lv, lf);
  fold<T, Op>(cv, cf, sm.wv[kWarps - 1], sm.wf[kWarps - 1]);
  if (out != nullptr) {
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      fold<T, Op>(pv, pf, x[r], fl[r]);
      sm.v[padded(tid * kItems + r)] = pv;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kItems; ++r) {  // coalesced store
      const int i = r * kThreads + tid;
      const int64_t g = base + i;
      if (g < n && g + shift < n_out) out[g + shift] = sm.v[padded(i)];
    }
  }
  __syncthreads();  // the next tile overwrites the shared arrays
}

template <class T, class Op>
__global__ void __launch_bounds__(kThreads)
tile_reduce(const T* __restrict__ vals, const uint8_t* __restrict__ flags,
            int64_t n, T* __restrict__ tile_v, uint8_t* __restrict__ tile_f) {
  __shared__ Smem<T> sm;
  T cv = Op::template ident<T>();
  int cf = 0;
  scan_tile<T, Op>(vals, flags, (int64_t)blockIdx.x * kTile, n, cv, cf,
                   nullptr, 0, 0, sm);
  if (threadIdx.x == 0) {
    tile_v[blockIdx.x] = cv;
    tile_f[blockIdx.x] = (uint8_t)cf;
  }
}

template <class T, class Op>
__global__ void __launch_bounds__(kThreads)
carry_scan(const T* __restrict__ tile_v, const uint8_t* __restrict__ tile_f,
           int64_t ntiles, T* __restrict__ carry) {
  __shared__ Smem<T> sm;
  T cv = Op::template ident<T>();
  int cf = 0;
  if (threadIdx.x == 0) carry[0] = cv;
  for (int64_t base = 0; base < ntiles; base += kTile)
    scan_tile<T, Op>(tile_v, tile_f, base, ntiles, cv, cf, carry, 1, ntiles,
                     sm);
}

template <class T, class Op>
__global__ void __launch_bounds__(kThreads)
tile_scan(const T* __restrict__ vals, const uint8_t* __restrict__ flags,
          int64_t n, const T* __restrict__ carry, T* __restrict__ out) {
  __shared__ Smem<T> sm;
  T cv = carry[blockIdx.x];
  int cf = 0;
  scan_tile<T, Op>(vals, flags, (int64_t)blockIdx.x * kTile, n, cv, cf, out,
                   0, n, sm);
}

template <class T, class Op>
int launch(const void* vals, const uint8_t* flags, int64_t n, void* out,
           void* tile_v, uint8_t* tile_f, void* carry, cudaStream_t st) {
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const T* v = static_cast<const T*>(vals);
  T* tv = static_cast<T*>(tile_v);
  T* cr = static_cast<T*>(carry);
  tile_reduce<T, Op><<<(unsigned)ntiles, kThreads, 0, st>>>(v, flags, n, tv,
                                                           tile_f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  carry_scan<T, Op><<<1, kThreads, 0, st>>>(tv, tile_f, ntiles, cr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  tile_scan<T, Op><<<(unsigned)ntiles, kThreads, 0, st>>>(
      v, flags, n, cr, static_cast<T*>(out));
  return cudaGetLastError();
}

template <class T>
int launch_combine(int combine, const void* vals, const uint8_t* flags,
                   int64_t n, void* out, void* tile_v, uint8_t* tile_f,
                   void* carry, cudaStream_t st) {
  switch (combine) {
    case 0:
      return launch<T, Sum>(vals, flags, n, out, tile_v, tile_f, carry, st);
    case 1:
      return launch<T, Min>(vals, flags, n, out, tile_v, tile_f, carry, st);
    case 2:
      return launch<T, Max>(vals, flags, n, out, tile_v, tile_f, carry, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int tt_seg_scan_tile(void) { return kTile; }

// Enqueues the scan on `stream`; returns the cudaError_t of the launches.
// dtype: 0 float32, 1 int32. combine: 0 sum, 1 min, 2 max.
// Scratch: tile_v and carry [ceil(n / kTile)] of the value type,
// tile_f [ceil(n / kTile)] u8.
int tt_seg_scan(int dtype, int combine, const void* vals, const uint8_t* flags,
                int64_t n, void* out, void* tile_v, uint8_t* tile_f,
                void* carry, void* stream) {
  if (n < 0 || n >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_combine<float>(combine, vals, flags, n, out, tile_v,
                                   tile_f, carry, st);
    case 1:
      return launch_combine<int32_t>(combine, vals, flags, n, out, tile_v,
                                     tile_f, carry, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
