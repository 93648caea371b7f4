// window_sum: each row's trailing-window sum by a log ladder, hand-written
// for Hopper (sm_90a). titan_tpu_torch/ops/window_sum.py holds the
// wrapper, its plain version and the timing entry point.
//
// Replaces _ok_kernel (tests/fixtures/graftlint/titan_tpu/models/
// pallas_ok.py:14, through run's pl.pallas_call at :29), which computes
// on the whole [R, W] array as one block:
//   v = x; for d = 1, 2, 4, ... while d < block: v = v + pad(v[:, :-d])
//   (d zeros on the left); then v * 2 if masked; then + 1 if R > 1.
// After the steps v[i] is the sum of the row's elements i - span + 1 .. i
// (span = twice the largest step, 128 at block = 128), added as a
// balanced binary tree: each step adds the value d to the left. Float32
// sums keep that tree, so the kernel repeats the steps themselves, and
// is bit-equal to the plain version, which repeats them too. Int32 adds
// wrap, as JAX's do (done on the bits as unsigned). v * 2 is exact, so
// whether it fuses with the + 1 changes nothing; both are done by the
// round-to-nearest intrinsics, which are never contracted.
//
// Bound: bytes, each element read once and written once (8 B).
//
// Design: a warp a window of L = 32 K consecutive elements of one row, K
// a lane in registers (K in {1, 2, 4, 8, 16}, the smallest with L >= W,
// at most 16). Each step is done in registers: for d < K a lane adds its
// own element e - d, or lane - 1's element K + e - d by one shuffle; for
// d >= K every element adds the same element of lane - d / K. A position
// left of the window adds 0: that is the pad's zero when the window
// starts the row. No shared memory and no barrier; at (2^21, 128) a warp
// takes a row as one int4 a lane, and a step costs at most 4 shuffles a
// lane (23 for the seven steps). One window a warp, the grid as many
// blocks of 8 warps as the windows need: a streaming pass over a grid of
// the resident blocks ran slower, as stream_copy's did (probes.cu). A
// row wider than L takes further windows, each starting `halo` = span -
// 1 elements left of its first output, so every output's tree lies
// inside its window (the halo's own values are wrong and are not
// written): window k >= 1 starts at L + (k - 1)(L - halo) - halo and
// writes its last L - halo positions.
// The wrapper refuses block > 256 (span 256), so L - halo >= 257.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// steps d = 1, 2, ..., 128: block <= 256
constexpr int kMaxSteps = 8;
constexpr uint32_t kFloatOne = 0x3f800000u;

template <bool kFloat>
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  if (kFloat)
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  return a + b;  // int32 wraps
}

template <bool kFloat>
__device__ __forceinline__ uint32_t twice(uint32_t a) {
  if (kFloat) return __float_as_uint(__fmul_rn(__uint_as_float(a), 2.0f));
  return a * 2u;
}

template <bool kFloat, int K>
__global__ void __launch_bounds__(kThreads)
    window_sum_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ out, int64_t rows, int width,
                      int block, int halo, int windows, int masked,
                      int plus_one, int vec) {
  constexpr int L = 32 * K;
  const int lane = threadIdx.x % 32;
  const int64_t total = rows * windows;
  for (int64_t w = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32;
       w < total; w += int64_t(gridDim.x) * kWarps) {
    const int64_t r = w / windows;
    const int k = int(w - r * windows);
    // window k: columns [ws, ws + L), writing [lo, hi)
    const int ws = k == 0 ? 0 : L + (k - 1) * (L - halo) - halo;
    const int lo = k == 0 ? 0 : ws + halo;
    const int hi = min(ws + L, width);
    const uint32_t* row = x + r * width;
    uint32_t* orow = out + r * width;
    const int c0 = ws + lane * K;
    // int4 moves where the row and the window sit on 16 bytes
    const bool v4 = K % 4 == 0 && vec && ws % 4 == 0;
    uint32_t v[K];
    if constexpr (K % 4 == 0) {
      if (v4) {
#pragma unroll
        for (int e = 0; e < K; e += 4) {
          uint4 q = make_uint4(0u, 0u, 0u, 0u);
          if (c0 + e < width)
            q = __ldcs(reinterpret_cast<const uint4*>(row + c0 + e));
          v[e] = q.x;
          v[e + 1] = q.y;
          v[e + 2] = q.z;
          v[e + 3] = q.w;
        }
      }
    }
    if (!v4) {
#pragma unroll
      for (int e = 0; e < K; ++e)
        v[e] = c0 + e < width ? __ldcs(row + c0 + e) : 0u;
    }
#pragma unroll
    for (int s = 0; s < kMaxSteps; ++s) {
      const int d = 1 << s;
      if (d >= block) break;
      uint32_t nv[K];
      if (d < K) {
#pragma unroll
        for (int e = 0; e < K; ++e) {
          uint32_t from;
          if (e >= d) {
            from = v[e >= d ? e - d : 0];
          } else {
            from = __shfl_up_sync(0xffffffffu, v[e < d ? K + e - d : 0], 1);
            if (lane == 0) from = 0u;
          }
          nv[e] = add<kFloat>(v[e], from);
        }
      } else {
        const int dl = d / K;
#pragma unroll
        for (int e = 0; e < K; ++e) {
          uint32_t from = 0u;
          if (dl < 32) {
            from = __shfl_up_sync(0xffffffffu, v[e], dl);
            if (lane < dl) from = 0u;
          }
          nv[e] = add<kFloat>(v[e], from);
        }
      }
#pragma unroll
      for (int e = 0; e < K; ++e) v[e] = nv[e];
    }
#pragma unroll
    for (int e = 0; e < K; ++e) {
      if (masked) v[e] = twice<kFloat>(v[e]);
      if (plus_one) v[e] = add<kFloat>(v[e], kFloat ? kFloatOne : 1u);
    }
    bool stored = false;
    if constexpr (K % 4 == 0) {
      if (v4 && lo == ws) {
#pragma unroll
        for (int e = 0; e < K; e += 4)
          if (c0 + e < hi)
            __stcs(reinterpret_cast<uint4*>(orow + c0 + e),
                   make_uint4(v[e], v[e + 1], v[e + 2], v[e + 3]));
        stored = true;
      }
    }
    if (!stored) {
#pragma unroll
      for (int e = 0; e < K; ++e)
        if (c0 + e >= lo && c0 + e < hi) __stcs(orow + c0 + e, v[e]);
    }
  }
}

template <bool kFloat, int K>
cudaError_t launch(const uint32_t* x, uint32_t* out, int64_t rows,
                   int width, int block, int halo, int masked, int plus_one,
                   int vec, cudaStream_t st) {
  constexpr int L = 32 * K;
  const int windows =
      width <= L ? 1 : 1 + (width - L + (L - halo) - 1) / (L - halo);
  auto* kernel = window_sum_kernel<kFloat, K>;
  // one window a warp: as many blocks as the windows need
  int64_t need = (rows * windows + kWarps - 1) / kWarps;
  if (need > 0x7fffffff) need = 0x7fffffff;
  const unsigned grid = unsigned(need);
  kernel<<<grid, kThreads, 0, st>>>(x, out, rows, width, block, halo,
                                    windows, masked, plus_one, vec);
  return cudaGetLastError();
}

template <bool kFloat>
cudaError_t dispatch(const uint32_t* x, uint32_t* out, int64_t rows,
                     int width, int block, int halo, int masked,
                     int plus_one, int vec, cudaStream_t st) {
  if (width <= 32)
    return launch<kFloat, 1>(x, out, rows, width, block, halo, masked,
                             plus_one, vec, st);
  if (width <= 64)
    return launch<kFloat, 2>(x, out, rows, width, block, halo, masked,
                             plus_one, vec, st);
  if (width <= 128)
    return launch<kFloat, 4>(x, out, rows, width, block, halo, masked,
                             plus_one, vec, st);
  if (width <= 256)
    return launch<kFloat, 8>(x, out, rows, width, block, halo, masked,
                             plus_one, vec, st);
  return launch<kFloat, 16>(x, out, rows, width, block, halo, masked,
                            plus_one, vec, st);
}

}  // namespace

extern "C" {

// out [rows, width] = the ladder of x [rows, width] with steps d < block
// (block <= 256; width >= the largest step), then * 2 if masked, then + 1
// if plus_one; is_float: float32, else int32. x and out may be any
// 4-byte-aligned addresses; int4 moves are used where both and the row
// width sit on 16 bytes.
int tt_window_sum(const void* x, void* out, int64_t rows, int width,
                  int block, int is_float, int masked, int plus_one,
                  void* stream) {
  int dmax = 0;
  for (int d = 1; d < block; d <<= 1) dmax = d;
  if (rows < 0 || width < 0 || block > 256 || width < dmax)
    return cudaErrorInvalidValue;
  if (rows == 0 || width == 0) return cudaSuccess;
  const int halo = dmax ? 2 * dmax - 1 : 0;
  const int vec = width % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* oi = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_float ? dispatch<true>(xi, oi, rows, width, block, halo, masked,
                                   plus_one, vec, st)
                  : dispatch<false>(xi, oi, rows, width, block, halo,
                                    masked, plus_one, vec, st);
}

}  // extern "C"
