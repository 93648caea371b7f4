// probes: the access-pattern probes of experiments/, hand-written for
// Hopper (sm_90a). Six kernels that each do one memory pattern the BFS
// lives on, so the card's own rate for that pattern can be set beside
// the data sheet's 3.35 TB/s (titan_tpu_torch/ops/probes.py holds the
// wrappers, their plain versions, the byte models and run_probes).
//
// Every array is int32. Offsets are int64 throughout. Each kernel is a
// grid-stride loop over as many blocks as fit on the card at once
// (grid_for), except where its note says otherwise. Each C entry point
// enqueues one launch on the caller's stream and returns
// cudaGetLastError(); the wrapper checks shapes, alignment and ranges
// before it calls, and raises on a nonzero return.
//
// The TPU probes kept their tables in VMEM on purpose. On the card a
// table of 1-8 MB stays in the 50 MB L2 once it is warm, so those probes
// time L2, not HBM; the streams (idx, values, outputs: 256 MB-1 GiB) and
// a 256 MB table time HBM. Nothing here flushes L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// segment_copy: copies one block keeps in flight, at most
constexpr int kMaxInflight = 32;
// segment_copy: a bulk copy's bytes are counted by its mbarrier's
// transaction count, which holds less than 2^20
constexpr int64_t kMaxCopyBytes = int64_t(1) << 20;
// row_shuffle: a row is one warp's 32 lanes of 4 elements
constexpr int kRowWidth = 128;
// tile_transpose: a tile of kTile x kTile moved in kSub x kSub pieces
constexpr int kTile = 128;
constexpr int kSub = 32;
constexpr int kPieces = (kTile / kSub) * (kTile / kSub);

// The blocks of `kernel` that fit on the current device at once with
// `smem` bytes of dynamic shared memory (the attribute raised past 48 KB
// first), at most `need`.
template <class K>
cudaError_t grid_for(K kernel, int threads, size_t smem, int64_t need,
                     unsigned* grid) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t resident = int64_t(sms) * per_sm;
  *grid = unsigned(need < resident ? need : resident);
  return cudaSuccess;
}

__device__ __forceinline__ int64_t thread_id() {
  return int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t thread_count() {
  return int64_t(gridDim.x) * blockDim.x;
}

// ------------------------------------------------------------ stream_copy
// out = x. Replaces the TPU probes' copy kernels: copy_kernel
// (experiments/probe_pallas_gather.py:56, stream_copy :61) and the copy
// lambda of experiments/probe2_rates.py:178 (through stream1, :44).
// Bound: bytes, each element read once and written once (8 B).
// Design (scripts/torch_copy_scatter_variants.py keeps the original
// kernel and the designs tried): 16-byte loads and stores,
// neighbouring threads on neighbouring vectors, one vector a thread and
// the grid as many blocks of kCopyThreads as the vectors need, so the
// block scheduler, not a loop, walks the array. The original kernel looped
// over a grid of the resident blocks (its SASS: one LDG.E.EF.128, then
// its STG, an iteration) at 84-86% of the bound; over that grid 2-8
// loads a thread issued before the stores moved it under 1%, and bulk
// copies through shared memory (cp.async.bulk) reached 87-90%, while one
// vector a thread over the full grid reached 90-91%, with or without
// the streaming hints or a 256 B L2 prefetch, at 128-1024 threads a
// block (H100 80GB HBM3, 700 W). The n % 4 tail by block 0's first
// threads.
constexpr int kCopyThreads = 1024;

__global__ void __launch_bounds__(kCopyThreads)
    stream_copy_kernel(const int32_t* __restrict__ x,
                       int32_t* __restrict__ out, int64_t n) {
  const int64_t n4 = n / 4;
  const int4* x4 = reinterpret_cast<const int4*>(x);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (int64_t q = thread_id(); q < n4; q += thread_count()) o4[q] = x4[q];
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4)
    out[n4 * 4 + threadIdx.x] = x[n4 * 4 + threadIdx.x];
}

// ----------------------------------------------------------- table_gather
// out[i, j] = tab[idx[i, j], j], and with kBits (w >> shift[i, j]) & 1
// of that word. Replaces gather_kernel (experiments/probe_pallas_gather.py
// :68; lane_gather :73, lane_gather_check :80), gather_kernel of
// experiments/pallas_gather_bench.py:18 (run :25), kernel2 of
// experiments/probe2_rates.py:85 (vreg_gather's g, :90: an 8-row table
// the TPU had to tile to 2048 rows; here the 8 rows are the table) and
// lookup1024_kernel (probe2_rates.py:108, the bit epilogue).
// Bound: bytes, idx (and shift) read once, out written once, the table
// read once: a table in L2 costs HBM nothing after the first touch. A
// table beyond L2 costs one 32-byte sector a lookup (the 4 bytes used
// and 28 that come with them), which ops/probes.py counts as the sector
// model; then the kernel is bound by how many scattered sectors HBM
// serves a second. This probe measures that rate for lookups spread
// uniformly over the table: a lower bound on the card's rate, which
// reads with any locality beat.
// Design: one thread for each 4 output elements (a row of W % 4 == 0
// words, so the 4 share a row and take columns j..j+3): idx (and shift)
// loaded and out stored as int4 with the streaming hints, so the 1 GiB
// streams do not push the table out of L2; 4 independent table loads a
// thread, read through the read-only path (__ldg). The probes' 1-8 MB
// tables are read from L2, which holds them. Tried and dropped
// (scripts/torch_gather_variants.py, which keeps both): staging a table
// of at most 448 rows in shared memory was within 1% at the 8-row tile
// and 25% slower at 448 rows (bank conflicts, one block an SM); up to 32
// lookups in flight a thread, in place of 4, moved neither the 8 MB nor
// the 256 MB table.
template <bool kBits>
__global__ void table_gather_kernel(const int32_t* __restrict__ tab,
                                    const int32_t* __restrict__ idx,
                                    const int32_t* __restrict__ shift,
                                    int32_t* __restrict__ out, int width,
                                    int64_t n4) {
  const int w4 = width / 4;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  const int4* s4 = reinterpret_cast<const int4*>(shift);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (int64_t q = thread_id(); q < n4; q += thread_count()) {
    const int4 k = __ldcs(i4 + q);
    const int64_t j = (q % w4) * 4;
    int4 v;
    v.x = __ldg(tab + int64_t(k.x) * width + j);
    v.y = __ldg(tab + int64_t(k.y) * width + j + 1);
    v.z = __ldg(tab + int64_t(k.z) * width + j + 2);
    v.w = __ldg(tab + int64_t(k.w) * width + j + 3);
    if (kBits) {
      // int32 >> is arithmetic here as in torch and JAX; the probes'
      // words lie in [0, 2^20) and their shifts in [0, 32)
      const int4 s = __ldcs(s4 + q);
      v.x = (v.x >> s.x) & 1;
      v.y = (v.y >> s.y) & 1;
      v.z = (v.z >> s.z) & 1;
      v.w = (v.w >> s.w) & 1;
    }
    __stcs(o4 + q, v);
  }
}

template <bool kBits>
cudaError_t launch_gather(const int32_t* tab, const int32_t* idx,
                          const int32_t* shift, int32_t* out, int width,
                          int64_t n4, cudaStream_t st) {
  auto* kernel = table_gather_kernel<kBits>;
  unsigned grid;
  const cudaError_t e = grid_for(kernel, kThreads, 0,
                                 (n4 + kThreads - 1) / kThreads, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, 0, st>>>(tab, idx, shift, out, width, n4);
  return cudaGetLastError();
}

// ------------------------------------------------------------ row_shuffle
// out[i, j] = v[i, idx[i, j]], rows of 128 words, idx in [0, 128).
// Replaces shuffle_kernel (experiments/probe_pallas_gather.py:87,
// lane_shuffle :92) and shuffle_kernel of experiments/probe2_rates.py:58
// (through stream1, :44). Bound: bytes, v and idx read once and out
// written once (12 B an element). Design: a warp a row. Each lane loads
// its 4 words of the row as one int4 into the warp's 512 B of shared
// memory (the row goes through shared memory, not __shfl_sync: a lane's
// 4 lookups may hit 4 lanes and 4 registers each, 16 shuffles against 4
// shared loads), loads its 4 indices as one int4, reads the 4 words
// from shared memory and stores them as one int4. Random indices into
// 32 banks give a few-way bank conflict, far under the bytes' time.
__global__ void row_shuffle_kernel(const int32_t* __restrict__ v,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out, int64_t rows) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int4 row4[kWarps][kRowWidth / 4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int32_t* row = reinterpret_cast<const int32_t*>(row4[warp]);
  const int4* v4 = reinterpret_cast<const int4*>(v);
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (int64_t r = int64_t(blockIdx.x) * kWarps + warp; r < rows;
       r += int64_t(gridDim.x) * kWarps) {
    const int64_t q = r * (kRowWidth / 4) + lane;
    row4[warp][lane] = __ldcs(v4 + q);
    const int4 k = __ldcs(i4 + q);
    __syncwarp();
    int4 o;
    o.x = row[k.x];
    o.y = row[k.y];
    o.z = row[k.z];
    o.w = row[k.w];
    __stcs(o4 + q, o);
    __syncwarp();  // the row is read before the next one overwrites it
  }
}

// ---------------------------------------------------------- table_scatter
// tab[idx[i, j], j] set to (kMode 0), maxed with (1) or added to (2)
// val[i, j], into a zeroed table; add wraps as int32. With set, a cell
// written more than once holds one of the values written to it.
// Replaces make_scatter_kernel's kernels (experiments/probe_pallas_gather
// .py:100, lane_scatter :115; modes set and at_set are set, at_max max,
// at_add add), which scatter into a VMEM scratch and never write their
// output.
// Bound: bytes, idx and val read once (8 B an element) and the table
// written once.
// Design (scripts/torch_copy_scatter_variants.py keeps the original
// kernel and the designs tried): column j only ever
// receives idx[:, j], so the table splits into stripes of C columns (8,
// or 4 where the width is not a multiple of 8) whose rows fit one
// block's shared memory (the slab, C x (T + 1) words, column by column
// with a stride of T + 1 so a warp's updates and reads spread over the
// banks). Block b takes stripe b % S and range b / S of the idx rows
// (S stripes x R ranges, R the blocks that fit on the card at once over
// S): C / 4 int4s of idx and of val a row, 4 rows' loads in flight a
// thread, updates into its zeroed slab by shared-memory atomics (plain
// stores for set), then one global atomic or store for each nonzero
// cell of the slab into the zeroed table (a zero adds nothing, maxes
// nothing past the zeros, and is a value the cell may hold for set):
// 16 times fewer global updates than the original design at the probe's
// shape, which does one a update (128 a cell of the 2 MB table, resolved
// in L2). Tried and dropped: a cluster of blocks a stripe reducing its
// slabs through distributed shared memory and writing every cell once
// (no memset, no global atomic) was 20-40% slower at the probe's shape.
// The original design stays for tables whose stripe of 4 columns does not
// fit (scatter_path in ops/probes.py decides by shape).
constexpr int kSlabThreads = 1024;
constexpr int kSlabUnroll = 4;

template <int kMode>
__device__ __forceinline__ void put(int32_t* p, int32_t v) {
  if (kMode == 0)
    *p = v;
  else if (kMode == 1)
    atomicMax(p, v);
  else
    atomicAdd(p, v);
}

template <int kMode>
__global__ void table_scatter_kernel(const int32_t* __restrict__ idx,
                                     const int32_t* __restrict__ val,
                                     int32_t* __restrict__ tab, int width,
                                     int64_t n4) {
  const int w4 = width / 4;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  const int4* v4 = reinterpret_cast<const int4*>(val);
  for (int64_t q = thread_id(); q < n4; q += thread_count()) {
    const int4 k = __ldcs(i4 + q);
    const int4 v = __ldcs(v4 + q);
    const int64_t j = (q % w4) * 4;
    put<kMode>(tab + int64_t(k.x) * width + j, v.x);
    put<kMode>(tab + int64_t(k.y) * width + j + 1, v.y);
    put<kMode>(tab + int64_t(k.z) * width + j + 2, v.z);
    put<kMode>(tab + int64_t(k.w) * width + j + 3, v.w);
  }
}

template <int kMode>
cudaError_t launch_scatter(const int32_t* idx, const int32_t* val,
                           int32_t* tab, int width, int64_t n4,
                           cudaStream_t st) {
  auto* kernel = table_scatter_kernel<kMode>;
  unsigned grid;
  const cudaError_t e =
      grid_for(kernel, kThreads, 0, (n4 + kThreads - 1) / kThreads, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, 0, st>>>(idx, val, tab, width, n4);
  return cudaGetLastError();
}

template <int kMode, int C>
__global__ void __launch_bounds__(kSlabThreads)
    table_scatter_slab_kernel(const int32_t* __restrict__ idx,
                              const int32_t* __restrict__ val,
                              int32_t* __restrict__ tab, int width,
                              int t_rows, int64_t rows, int ranges) {
  extern __shared__ int4 slab4[];
  int32_t* slab = reinterpret_cast<int32_t*>(slab4);
  const int ld = t_rows + 1;
  const int stripes = width / C;
  const int stripe = int(blockIdx.x % stripes);
  const int range = int(blockIdx.x / stripes);
  for (int i = threadIdx.x; i < C * ld; i += blockDim.x) slab[i] = 0;
  __syncthreads();
  constexpr int Q = C / 4;  // int4s of a stripe's row
  const int64_t r0 = rows * range / ranges;
  const int64_t units = (rows * (range + 1) / ranges - r0) * Q;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  const int4* v4 = reinterpret_cast<const int4*>(val);
  const int w4 = width / 4;
  for (int64_t u0 = threadIdx.x; u0 < units;
       u0 += int64_t(blockDim.x) * kSlabUnroll) {
    int4 k[kSlabUnroll], v[kSlabUnroll];
#pragma unroll
    for (int j = 0; j < kSlabUnroll; ++j) {
      const int64_t u = u0 + int64_t(j) * blockDim.x;
      k[j] = v[j] = make_int4(0, 0, 0, 0);
      if (u < units) {
        const int64_t at = (r0 + u / Q) * w4 + stripe * Q + u % Q;
        k[j] = __ldcs(i4 + at);
        v[j] = __ldcs(v4 + at);
      }
    }
#pragma unroll
    for (int j = 0; j < kSlabUnroll; ++j) {
      const int64_t u = u0 + int64_t(j) * blockDim.x;
      if (u < units) {
        int32_t* col = slab + int(u % Q) * 4 * ld;
        put<kMode>(col + k[j].x, v[j].x);
        put<kMode>(col + ld + k[j].y, v[j].y);
        put<kMode>(col + 2 * ld + k[j].z, v[j].z);
        put<kMode>(col + 3 * ld + k[j].w, v[j].w);
      }
    }
  }
  __syncthreads();
  // the slab's nonzero cells, row by row: a warp's atomics or stores
  // fall on whole rows of the stripe
  for (int i = threadIdx.x; i < t_rows * C; i += blockDim.x) {
    const int row = i / C, c = i % C;
    const int32_t v = slab[c * ld + row];
    if (v != 0) put<kMode>(tab + int64_t(row) * width + stripe * C + c, v);
  }
}

template <int kMode, int C>
cudaError_t launch_scatter_slab(const int32_t* idx, const int32_t* val,
                                int32_t* tab, int width, int t_rows,
                                int64_t rows, cudaStream_t st) {
  auto* kernel = table_scatter_slab_kernel<kMode, C>;
  const int stripes = width / C;
  unsigned fit;
  const cudaError_t e = grid_for(kernel, kSlabThreads,
                                 size_t(C) * (t_rows + 1) * 4, INT32_MAX,
                                 &fit);
  if (e != cudaSuccess) return e;
  const int ranges = int(fit) / stripes > 1 ? int(fit) / stripes : 1;
  kernel<<<unsigned(stripes * ranges), kSlabThreads,
           size_t(C) * (t_rows + 1) * 4, st>>>(idx, val, tab, width, t_rows,
                                               rows, ranges);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t scatter_mode(const int32_t* idx, const int32_t* val,
                         int32_t* tab, int64_t t_rows, int width, int64_t n,
                         int stripe, cudaStream_t st) {
  if (n == 0) return cudaSuccess;
  if (stripe == 8)
    return launch_scatter_slab<kMode, 8>(idx, val, tab, width, int(t_rows),
                                         n / width, st);
  if (stripe == 4)
    return launch_scatter_slab<kMode, 4>(idx, val, tab, width, int(t_rows),
                                         n / width, st);
  return launch_scatter<kMode>(idx, val, tab, width, n / 4, st);
}

// --------------------------------------------------------- tile_transpose
// Each 128 x 128 tile of an [N, 128] array (N % 128 == 0) transposed in
// place of itself: out[t*128 + c, r] = v[t*128 + r, c]. Replaces
// transpose_kernel (experiments/probe2_rates.py:136, through stream1,
// :44). Bound: bytes, each element read once and written once (8 B).
// Design: a tile moves in 16 pieces of 32 x 32 through a padded 32 x 33
// shared tile, one piece a block-step (blocks of 32 x 8 threads): a warp
// reads 32 consecutive words of a row (128 B, whole sectors) and, after
// the barrier, writes 32 consecutive words of a row of the output; the
// padding puts a column's 32 words in 32 banks, so reading the piece by
// column has no bank conflict. Loads and stores stay coalesced both ways.
__global__ void tile_transpose_kernel(const int32_t* __restrict__ v,
                                      int32_t* __restrict__ out,
                                      int64_t tiles) {
  __shared__ int32_t piece[kSub][kSub + 1];
  const int x = threadIdx.x;
  for (int64_t p = blockIdx.x; p < tiles * kPieces; p += gridDim.x) {
    const int64_t base = (p / kPieces) * kTile * kTile;
    const int a = int(p % kPieces) / (kTile / kSub);  // piece row
    const int b = int(p % kPieces) % (kTile / kSub);  // piece column
    const int32_t* src = v + base + int64_t(a * kSub) * kTile + b * kSub;
    int32_t* dst = out + base + int64_t(b * kSub) * kTile + a * kSub;
    for (int r = threadIdx.y; r < kSub; r += blockDim.y)
      piece[r][x] = __ldcs(src + int64_t(r) * kTile + x);
    __syncthreads();
    for (int r = threadIdx.y; r < kSub; r += blockDim.y)
      __stcs(dst + int64_t(r) * kTile + x, piece[x][r]);
    __syncthreads();  // the piece is read before the next one is loaded
  }
}

// ----------------------------------------------------------- segment_copy
// For every segment k with lens[k] > 0 (every k when lens is null):
// out[outpos[k] : outpos[k] + L] = src[starts[k] : starts[k] + L], L the
// same for every segment, offsets in int32 elements (a segment of R rows
// of 128 words is starts * 128 and L = R * 128). Replaces the DMA probes'
// kernels, each a loop of pltpu.make_async_copy with semaphores:
// make_kernel (experiments/probe3_dma.py:26, run :74), the V1-V6 kernels
// of experiments/probe3b_bisect.py:30-150, the W1-W3 kernels of
// experiments/probe3c_2d.py:30-120 and seg_copy's kernel
// (experiments/probe3d_rate.py:19, :55).
// Bound: bytes, each live segment read once and written once, and the
// starts, outpos and lens arrays read once. A segment is 512 B-16 KB at
// a random start, so the bound is met only with many copies in flight
// across the card, which is what this probe measures against
// `inflight`.
// Design: the counterpart of make_async_copy with semaphores is the bulk
// asynchronous copy (cp.async.bulk, the TMA engine's 1D form) on an
// mbarrier. One thread of each block runs the pipeline; the block's
// segments are k = blockIdx.x, + gridDim.x, ... Each block keeps up to
// `inflight` copies in flight (the TPU kernels' semaphore count; on the
// TPU one core held them all, here every resident block holds its own),
// each in its own stage of L bytes of shared memory:
//   1. load: mbarrier.arrive.expect_tx of L bytes on the stage's barrier,
//      then cp.async.bulk global -> shared completing on it;
//   2. store: wait on the barrier with the stage's phase parity (it
//      flips each reuse of the stage: use u of a stage waits parity
//      u & 1), fence.proxy.async, then cp.async.bulk shared -> global as
//      one bulk group;
//   3. refill: the load after next reuses the stage of the segment
//      stored one step earlier, after cp.async.bulk.wait_group.read 1
//      (every store but the newest has read its stage), so a stage is
//      never overwritten before its store has read it; with one stage
//      the wait is for the newest store (wait_group.read 0).
// The last step waits for every store (wait_group 0) before the block
// ends. Both addresses and L must be multiples of 16 bytes; the wrapper
// checks that and the ranges. The block's threads other than thread 0
// exit at once: the copy engine, not the threads, moves the bytes.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

__global__ void __launch_bounds__(32)
    segment_copy_kernel(const int32_t* __restrict__ src,
                        const int32_t* __restrict__ starts,
                        const int32_t* __restrict__ lens,
                        const int32_t* __restrict__ outpos,
                        int32_t* __restrict__ out, int64_t nseg,
                        uint32_t bytes, int inflight) {
  extern __shared__ __align__(128) uint8_t stages[];
  __shared__ __align__(8) uint64_t bar[kMaxInflight];
  __shared__ int64_t dst_of[kMaxInflight];
  if (threadIdx.x != 0) return;
  for (int s = 0; s < inflight; ++s) mbar_init(&bar[s]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  const int64_t step = gridDim.x;
  int64_t k = blockIdx.x;  // the next segment to load
  auto skip_dead = [&] {
    while (k < nseg && lens != nullptr && __ldg(lens + k) <= 0) k += step;
  };
  int64_t issued = 0;  // loads issued; load i uses stage i % inflight
  auto issue = [&] {
    const int s = int(issued % inflight);
    dst_of[s] = __ldg(outpos + k);
    bulk_load(stages + size_t(s) * bytes, src + __ldg(starts + k), bytes,
              &bar[s]);
    ++issued;
    k += step;
    skip_dead();
  };
  skip_dead();
  while (issued < inflight && k < nseg) issue();
  const int lag = inflight > 1 ? 1 : 0;
  for (int64_t done = 0; done < issued; ++done) {
    const int s = int(done % inflight);
    mbar_wait(&bar[s], uint32_t((done / inflight) & 1));
    bulk_store(out + dst_of[s], stages + size_t(s) * bytes, bytes);
    if (done >= lag && k < nseg) {
      // load issued = done - lag + inflight reuses the stage of store
      // done - lag: wait until that store has read it
      if (lag)
        bulk_wait_read<1>();
      else
        bulk_wait_read<0>();
      issue();
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" {

int tt_probe_max_inflight(void) { return kMaxInflight; }

// out = x, n int32 words; x and out 16-byte aligned.
int tt_stream_copy(const int32_t* x, int32_t* out, int64_t n, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int64_t grid = (n / 4 + kCopyThreads - 1) / kCopyThreads;
  if (grid < 1) grid = 1;
  if (grid > 0x7fffffff) grid = 0x7fffffff;
  stream_copy_kernel<<<unsigned(grid), kCopyThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return cudaGetLastError();
}

// out [n / width, width] = tab [t_rows, width] gathered by idx [n / width,
// width], each index in [0, t_rows); with shift (not null) the bit
// epilogue. width % 4 == 0, n % width == 0, every pointer 16-byte aligned.
int tt_table_gather(const int32_t* tab, const int32_t* idx,
                    const int32_t* shift, int32_t* out, int64_t t_rows,
                    int width, int64_t n, void* stream) {
  if (t_rows < 1 || width < 4 || width % 4 != 0 || n < 0 || n % width != 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return shift ? launch_gather<true>(tab, idx, shift, out, width, n / 4, st)
               : launch_gather<false>(tab, idx, shift, out, width, n / 4, st);
}

// out [rows, 128] = each row of v [rows, 128] permuted by idx [rows, 128]
// (every index in [0, 128)); pointers 16-byte aligned.
int tt_row_shuffle(const int32_t* v, const int32_t* idx, int32_t* out,
                   int64_t rows, void* stream) {
  if (rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  constexpr int kWarps = kThreads / 32;
  unsigned grid;
  const cudaError_t e = grid_for(row_shuffle_kernel, kThreads, 0,
                                 (rows + kWarps - 1) / kWarps, &grid);
  if (e != cudaSuccess) return e;
  row_shuffle_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, idx, out, rows);
  return cudaGetLastError();
}

// tab [t_rows, width] (zeroed by the caller) updated by idx and val
// [n / width, width], every index a row of tab; mode 0 set, 1 max, 2
// add. stripe 8 or 4: the slab design (C x (t_rows + 1) words must fit a
// block's shared memory); stripe 0: the global design. width % 4 == 0 (%
// stripe), n % width == 0, idx and val 16-byte aligned.
int tt_table_scatter(const int32_t* idx, const int32_t* val, int32_t* tab,
                     int64_t t_rows, int width, int64_t n, int mode,
                     int stripe, void* stream) {
  if (width < 4 || width % 4 != 0 || n < 0 || n % width != 0 ||
      t_rows < 1 || (stripe != 0 && stripe != 4 && stripe != 8) ||
      (stripe && width % stripe != 0))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return scatter_mode<0>(idx, val, tab, t_rows, width, n, stripe, st);
    case 1:
      return scatter_mode<1>(idx, val, tab, t_rows, width, n, stripe, st);
    case 2:
      return scatter_mode<2>(idx, val, tab, t_rows, width, n, stripe, st);
  }
  return cudaErrorInvalidValue;
}

// out [rows, 128] = v [rows, 128] with each 128 x 128 tile transposed;
// rows % 128 == 0.
int tt_tile_transpose(const int32_t* v, int32_t* out, int64_t rows,
                      void* stream) {
  if (rows < 0 || rows % kTile != 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int64_t tiles = rows / kTile;
  unsigned grid;
  const cudaError_t e = grid_for(tile_transpose_kernel, kThreads, 0,
                                 tiles * kPieces, &grid);
  if (e != cudaSuccess) return e;
  tile_transpose_kernel<<<grid, dim3(kSub, kThreads / kSub), 0,
                          static_cast<cudaStream_t>(stream)>>>(v, out, tiles);
  return cudaGetLastError();
}

// The segment copy of nseg segments of `length` int32 words; lens may be
// null (every segment live). The caller has checked every live segment's
// ranges and that src, out, starts * 4, outpos * 4 and length * 4 are
// multiples of 16 bytes; inflight * length * 4 bytes of stages must fit
// in a block's shared memory.
int tt_segment_copy(const int32_t* src, const int32_t* starts,
                    const int32_t* lens, const int32_t* outpos, int32_t* out,
                    int64_t nseg, int64_t length, int inflight,
                    void* stream) {
  if (nseg < 0 || length < 4 || length % 4 != 0 || inflight < 1 ||
      inflight > kMaxInflight || length * 4 >= kMaxCopyBytes)
    return cudaErrorInvalidValue;
  if (nseg == 0) return cudaSuccess;
  const uint32_t bytes = uint32_t(length * 4);
  const size_t smem = size_t(inflight) * bytes;
  unsigned grid;
  const cudaError_t e = grid_for(segment_copy_kernel, 32, smem, nseg, &grid);
  if (e != cudaSuccess) return e;
  segment_copy_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      src, starts, lens, outpos, out, nseg, bytes, inflight);
  return cudaGetLastError();
}

}  // extern "C"
