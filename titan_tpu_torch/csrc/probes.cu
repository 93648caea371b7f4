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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// segment_copy: copies one block keeps in flight, at most
constexpr int kMaxInflight = 32;
// segment_copy: a bulk copy's bytes are counted by its mbarrier's
// transaction count, which holds less than 2^20
constexpr int64_t kMaxCopyBytes = int64_t(1) << 20;
// table_gather's and table_scatter's slab designs: threads a block, and
// rows' loads in flight a thread
constexpr int kSlabThreads = 1024;
constexpr int kSlabUnroll = 4;
// row_shuffle: a row is one warp's 32 lanes of 4 elements
constexpr int kRowWidth = 128;
// tile_transpose: a tile of kTile x kTile moved in kSub x kSub pieces
constexpr int kTile = 128;
constexpr int kSub = 32;
constexpr int kPieces = (kTile / kSub) * (kTile / kSub);

// The blocks of `kernel` that fit on the current device at once with
// `smem` bytes of dynamic shared memory (the attribute set to it first),
// at most `need`.
template <class K>
cudaError_t grid_for(K kernel, int threads, size_t smem, int64_t need,
                     unsigned* grid) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 0)
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
// Design: three, picked by shape (ops/probes.gather_path). The
// per-lookup kernel below: one thread for each 4 output elements (a row
// of W % 4 == 0 words, so the 4 share a row and take columns j..j+3),
// one int4 of idx a thread over as many blocks as the array needs (the
// original loop over a grid of the resident blocks was 1-6% slower;
// scripts/torch_gather_segment_variants.py keeps it): idx (and shift)
// loaded and out stored as
// int4 with the streaming hints, so the 1 GiB streams do not push the
// table out of L2; 4 independent table loads a thread, read through the
// read-only path (__ldg). Then the slab and the pair, below it. Tried
// and dropped for the per-lookup kernel (scripts/torch_gather_variants.py
// keeps both): staging a table of at most 448 rows in shared memory by
// one block an SM was within 1% at the 8-row tile and 25% slower at 448
// rows; up to 32 lookups in flight a thread, in place of 4, moved
// neither the 8 MB nor the 256 MB table.
constexpr int kGatherThreads = 1024;

// The bit epilogue: int32 >> is arithmetic here as in torch and JAX; the
// probes' words lie in [0, 2^20) and their shifts in [0, 32).
__device__ __forceinline__ int4 bits_of(int4 v, int4 s) {
  return make_int4((v.x >> s.x) & 1, (v.y >> s.y) & 1, (v.z >> s.z) & 1,
                   (v.w >> s.w) & 1);
}

template <bool kBits>
__global__ void __launch_bounds__(kGatherThreads)
    table_gather_kernel(const int32_t* __restrict__ tab,
                        const int32_t* __restrict__ idx,
                        const int32_t* __restrict__ shift,
                        int32_t* __restrict__ out, int width, int64_t n4) {
  const int64_t q = thread_id();
  if (q >= n4) return;
  const int4 k = __ldcs(reinterpret_cast<const int4*>(idx) + q);
  const int64_t j = (q % (width / 4)) * 4;
  int4 v;
  v.x = __ldg(tab + int64_t(k.x) * width + j);
  v.y = __ldg(tab + int64_t(k.y) * width + j + 1);
  v.z = __ldg(tab + int64_t(k.z) * width + j + 2);
  v.w = __ldg(tab + int64_t(k.w) * width + j + 3);
  if (kBits) v = bits_of(v, __ldcs(reinterpret_cast<const int4*>(shift) + q));
  __stcs(reinterpret_cast<int4*>(out) + q, v);
}

template <bool kBits>
cudaError_t launch_gather(const int32_t* tab, const int32_t* idx,
                          const int32_t* shift, int32_t* out, int width,
                          int64_t n4, cudaStream_t st) {
  const int64_t grid = (n4 + kGatherThreads - 1) / kGatherThreads;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  table_gather_kernel<kBits><<<unsigned(grid), kGatherThreads, 0, st>>>(
      tab, idx, shift, out, width, n4);
  return cudaGetLastError();
}

// The slab designs, for tables in L2: a lookup from L2 costs a 32-byte
// sector for its 4 bytes, so the per-lookup kernel is bound by L2's
// sector rate (2^28 lookups, 8.6 GB of sectors, about 4 TB/s), as
// torch.gather is. Column j reads only column j of the table, so block b
// takes stripe b % S of C columns and holds the stripe of every table
// row in shared memory, column by column with a stride of T + 1 (a warp's
// 32 random lookups in a column meet a few-way bank conflict); it then
// streams its range of idx rows: C / 4 int4s of idx (and of shift) a row,
// kSlabUnroll rows' loads in flight a thread, each word looked up in the
// slab, out stored as int4s. A row's stripe is C * 4 bytes of a 512 B
// row of idx and of out, so the S blocks of a range share every 128 B
// line of both streams. idx is read with ld.global.L2::128B (L2 fetches
// the whole line on a miss, for the neighbouring stripes' blocks), and
// `lock` neighbouring stripes' blocks (8 where S allows) run as one
// cluster that passes a cluster barrier every kSlabThreads * kSlabUnroll
// units (split arrive and wait: a block runs at most one step ahead), so
// a line is read from HBM once and an out line is completed while it is
// still in L2. Unlocked, the blocks drift apart over the 1 GiB streams
// and the lines are fetched and written back in pieces.
// The pair design, for a stripe of 8 too tall for one block (T up to
// 14526): the two blocks of a cluster each hold half of the stripe's rows
// and each streams its own idx rows, reading the other's half through
// distributed shared memory (one lookup in two crosses to the other SM).
// ops/probes.gather_path picks the design by shape: the per-lookup kernel
// for tables of at most 192 KB (served from L1: 88-91% of the bound, the
// slab 85%), the widest slab that fits, the pair, and the per-lookup
// kernel again for taller tables (T = 16384: a stripe of 8 needs four
// blocks' shared memory).
// Measured (scripts/torch_gather_segment_variants.py keeps every design
// tried; H100 80GB HBM3, 700 W), idx (2^21, 128) from T = 2048 and the
// 2 MB table's (524288, 128): locked, plain stores, 85-86% and 72% of
// the bound; locked with __stcs 1-3% slower; unlocked 54-63% (__ldcs)
// and 56-79% (L2::128B). Tried and dropped: stripes of 4 (half a sector
// of each stream a row: 12-15% of the bound unlocked, 31-36% locked, no
// faster than the pair at T = 8192); the rows of a tall table split
// over 2-5 blocks a stripe, each writing the words whose index falls in
// its rows (5-16%, locked or not: partial-sector writes); a cluster of
// 4 a stripe (three lookups in four remote: 13%); idx by L2::256B.
__device__ __forceinline__ int4 load_line(const int4* p) {
  int4 v;
  asm volatile("ld.global.L2::128B.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Rows [t0, t0 + span) of stripe `stripe`'s C columns into the slab.
template <int C>
__device__ __forceinline__ void load_slab(int32_t* slab, int ld,
                                          const int32_t* tab, int width,
                                          int stripe, int t0, int span) {
  constexpr int Q = C / 4;
  const int4* t4 = reinterpret_cast<const int4*>(tab);
  for (int i = threadIdx.x; i < span * Q; i += blockDim.x) {
    const int r = i / Q, q = i % Q;
    const int4 v = __ldg(t4 + int64_t(t0 + r) * (width / 4) + stripe * Q + q);
    int32_t* cell = slab + q * 4 * ld + r;
    cell[0] = v.x;
    cell[ld] = v.y;
    cell[2 * ld] = v.z;
    cell[3 * ld] = v.w;
  }
}

template <bool kBits, int C>
__global__ void __launch_bounds__(kSlabThreads)
    table_gather_slab_kernel(const int32_t* __restrict__ tab,
                             const int32_t* __restrict__ idx,
                             const int32_t* __restrict__ shift,
                             int32_t* __restrict__ out, int width,
                             int t_rows, int64_t rows, int lock, int ranges) {
  extern __shared__ int4 slab4[];
  int32_t* slab = reinterpret_cast<int32_t*>(slab4);
  const int stripes = width / C;
  const int stripe = int(blockIdx.x % stripes);
  const int range = int(blockIdx.x / stripes);
  const int ld = t_rows + 1;
  constexpr int Q = C / 4;  // int4s of a stripe's row
  const int w4 = width / 4;
  load_slab<C>(slab, ld, tab, width, stripe, 0, t_rows);
  __syncthreads();
  const int64_t r0 = rows * range / ranges;
  const int64_t units = (rows * (range + 1) / ranges - r0) * Q;
  const int64_t step = int64_t(blockDim.x) * kSlabUnroll;
  // the same count in every block of a cluster: they share the range
  const int64_t steps = (units + step - 1) / step;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  const int4* s4 = reinterpret_cast<const int4*>(shift);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (int64_t it = 0; it < steps; ++it) {
    if (lock > 1 && it > 0) cluster_wait();
    const int64_t u0 = it * step + threadIdx.x;
    int4 k[kSlabUnroll], s[kSlabUnroll];
    int64_t at[kSlabUnroll];
#pragma unroll
    for (int j = 0; j < kSlabUnroll; ++j) {
      const int64_t u = u0 + int64_t(j) * blockDim.x;
      at[j] = (r0 + u / Q) * w4 + stripe * Q + u % Q;
      k[j] = s[j] = make_int4(0, 0, 0, 0);
      if (u < units) {
        k[j] = load_line(i4 + at[j]);
        if (kBits) s[j] = load_line(s4 + at[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSlabUnroll; ++j) {
      if (u0 + int64_t(j) * blockDim.x >= units) continue;
      const int32_t* col = slab + int((u0 + int64_t(j) * blockDim.x) % Q) *
                                      4 * ld;
      int4 v = make_int4(col[k[j].x], col[ld + k[j].y], col[2 * ld + k[j].z],
                         col[3 * ld + k[j].w]);
      if (kBits) v = bits_of(v, s[j]);
      o4[at[j]] = v;
    }
    if (lock > 1) cluster_arrive();
  }
  if (lock > 1 && steps > 0) cluster_wait();
}

template <bool kBits>
__global__ void __launch_bounds__(kSlabThreads)
    table_gather_pair_kernel(const int32_t* __restrict__ tab,
                             const int32_t* __restrict__ idx,
                             const int32_t* __restrict__ shift,
                             int32_t* __restrict__ out, int width,
                             int t_rows, int64_t rows, int ranges) {
  constexpr int C = 8, Q = 2;
  extern __shared__ int4 slab4[];
  int32_t* slab = reinterpret_cast<int32_t*>(slab4);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = int(cl.block_rank());
  const int pair = int(blockIdx.x / 2);
  const int stripes = width / C;
  const int stripe = pair % stripes, range = pair / stripes;
  const int span = (t_rows + 1) / 2, ld = span + 1;
  load_slab<C>(slab, ld, tab, width, stripe, rank * span,
               rank ? t_rows - span : span);
  cl.sync();
  const int32_t* halves[2] = {cl.map_shared_rank(slab, 0u),
                              cl.map_shared_rank(slab, 1u)};
  // the pair's range of idx rows, split between its two blocks
  const int64_t sub = int64_t(range) * 2 + rank, subs = int64_t(ranges) * 2;
  const int64_t r0 = rows * sub / subs;
  const int64_t units = (rows * (sub + 1) / subs - r0) * Q;
  const int w4 = width / 4;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  const int4* s4 = reinterpret_cast<const int4*>(shift);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (int64_t u0 = threadIdx.x; u0 < units;
       u0 += int64_t(blockDim.x) * kSlabUnroll) {
    int4 k[kSlabUnroll], s[kSlabUnroll];
    int64_t at[kSlabUnroll];
#pragma unroll
    for (int j = 0; j < kSlabUnroll; ++j) {
      const int64_t u = u0 + int64_t(j) * blockDim.x;
      at[j] = (r0 + u / Q) * w4 + stripe * Q + u % Q;
      k[j] = s[j] = make_int4(0, 0, 0, 0);
      if (u < units) {
        k[j] = load_line(i4 + at[j]);
        if (kBits) s[j] = load_line(s4 + at[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSlabUnroll; ++j) {
      const int64_t u = u0 + int64_t(j) * blockDim.x;
      if (u >= units) continue;
      const int c0 = int(u % Q) * 4 * ld;
      const int kk[4] = {k[j].x, k[j].y, k[j].z, k[j].w};
      int w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = kk[e] >= span;
        w[e] = halves[hi][c0 + e * ld + kk[e] - hi * span];
      }
      int4 v = make_int4(w[0], w[1], w[2], w[3]);
      if (kBits) v = bits_of(v, s[j]);
      __stcs(o4 + at[j], v);
    }
  }
  cl.sync();  // no block leaves while the other reads its half
}

// A launch of `per_range` blocks a row range, as many ranges as fit on
// the card at once, in clusters of `cluster` consecutive blocks (1: no
// cluster); the kernel's last arguments are (..., ranges, tail...).
// The shared-memory attribute is set to `smem` at every launch: one
// kernel is launched with other sizes, and a launch that asks for more
// than the attribute last set is refused.
template <class... P, class... A>
cudaError_t launch_ranges(void (*kernel)(P...), int per_range, int cluster,
                          size_t smem, cudaStream_t st, A... head) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  int dev, sms, fit = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(unsigned(cluster));
  cfg.blockDim = dim3(kSlabThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  if (cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = unsigned(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    fit *= cluster;
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                      kSlabThreads, smem);
    fit *= sms;
  }
  if (e != cudaSuccess) return e;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const int ranges = fit / per_range > 1 ? fit / per_range : 1;
  cfg.gridDim = dim3(unsigned(per_range * ranges));
  e = cudaLaunchKernelEx(&cfg, kernel, head..., ranges);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool kBits>
cudaError_t gather_path(const int32_t* tab, const int32_t* idx,
                        const int32_t* shift, int32_t* out, int64_t t_rows,
                        int width, int64_t n, int stripe, int holders,
                        cudaStream_t st) {
  const int64_t rows = n / width;
  const int t = int(t_rows);
  if (holders == 2)
    return launch_ranges(table_gather_pair_kernel<kBits>, (width / 8) * 2, 2,
                         size_t(8) * ((t + 1) / 2 + 1) * 4, st, tab, idx,
                         shift, out, width, t, rows);
  if (stripe == 0)
    return launch_gather<kBits>(tab, idx, shift, out, width, n / 4, st);
  // lock: the most stripes, up to 8 and a power of 2, that divide S
  const int stripes = width / stripe;
  int lock = 8;
  while (stripes % lock) lock /= 2;
  const size_t smem = size_t(stripe) * (t + 1) * 4;
  if (stripe == 16)
    return launch_ranges(table_gather_slab_kernel<kBits, 16>, stripes, lock,
                         smem, st, tab, idx, shift, out, width, t, rows,
                         lock);
  return launch_ranges(table_gather_slab_kernel<kBits, 8>, stripes, lock,
                       smem, st, tab, idx, shift, out, width, t, rows, lock);
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

// The warp design, for short segments: a bulk copy of 512 B is one
// mbarrier round trip for 512 bytes, issued by one thread a block. Here
// warp w takes segments [w * inflight, (w + 1) * inflight): lane s holds
// segment s's start, outpos and liveness, and each step every lane loads
// one int4 of each of the warp's live segments (the loads of all
// `inflight` segments issued before their stores: `inflight` copies in
// flight a warp), then stores them, with the streaming hints; a segment
// of L words takes ceil(L / 128) steps. kWarpCopyThreads-thread blocks
// over as many blocks as the segments need. G >= inflight is the
// register buffer, a power of 2.
constexpr int kWarpCopyThreads = 256;

template <int G>
__global__ void __launch_bounds__(kWarpCopyThreads)
    segment_copy_warp_kernel(const int32_t* __restrict__ src,
                             const int32_t* __restrict__ starts,
                             const int32_t* __restrict__ lens,
                             const int32_t* __restrict__ outpos,
                             int32_t* __restrict__ out, int64_t nseg,
                             int64_t length4, int inflight) {
  const int lane = threadIdx.x % 32;
  const int64_t base =
      (int64_t(blockIdx.x) * (kWarpCopyThreads / 32) + threadIdx.x / 32) *
      inflight;
  if (base >= nseg) return;
  // int4 offsets of lane's segment, -1 where it is dead or past the end
  int from = -1, to = -1;
  if (lane < inflight && base + lane < nseg &&
      (lens == nullptr || __ldg(lens + base + lane) > 0)) {
    from = __ldg(starts + base + lane) / 4;
    to = __ldg(outpos + base + lane) / 4;
  }
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (int64_t q0 = 0; q0 < length4; q0 += 32) {
    const int64_t q = q0 + lane;
    int4 v[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int a = __shfl_sync(0xffffffffu, from, g);
      if (g < inflight && a >= 0 && q < length4) v[g] = __ldcs(s4 + a + q);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int a = __shfl_sync(0xffffffffu, to, g);
      if (g < inflight && a >= 0 && q < length4) __stcs(o4 + a + q, v[g]);
    }
  }
}

template <int G>
cudaError_t launch_segment_warp(const int32_t* src, const int32_t* starts,
                                const int32_t* lens, const int32_t* outpos,
                                int32_t* out, int64_t nseg, int64_t length,
                                int inflight, cudaStream_t st) {
  constexpr int kWarps = kWarpCopyThreads / 32;
  const int64_t warps = (nseg + inflight - 1) / inflight;
  const int64_t grid = (warps + kWarps - 1) / kWarps;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  segment_copy_warp_kernel<G><<<unsigned(grid), kWarpCopyThreads, 0, st>>>(
      src, starts, lens, outpos, out, nseg, length / 4, inflight);
  return cudaGetLastError();
}

cudaError_t segment_warp(const int32_t* src, const int32_t* starts,
                         const int32_t* lens, const int32_t* outpos,
                         int32_t* out, int64_t nseg, int64_t length,
                         int inflight, cudaStream_t st) {
  if (inflight <= 1)
    return launch_segment_warp<1>(src, starts, lens, outpos, out, nseg,
                                  length, inflight, st);
  if (inflight <= 2)
    return launch_segment_warp<2>(src, starts, lens, outpos, out, nseg,
                                  length, inflight, st);
  if (inflight <= 4)
    return launch_segment_warp<4>(src, starts, lens, outpos, out, nseg,
                                  length, inflight, st);
  if (inflight <= 8)
    return launch_segment_warp<8>(src, starts, lens, outpos, out, nseg,
                                  length, inflight, st);
  if (inflight <= 16)
    return launch_segment_warp<16>(src, starts, lens, outpos, out, nseg,
                                   length, inflight, st);
  return launch_segment_warp<32>(src, starts, lens, outpos, out, nseg,
                                 length, inflight, st);
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
// epilogue. (stripe, holders): (16 or 8, 1) the slab, C x (t_rows + 1)
// words of shared memory a block; (8, 2) the pair, 8 x (ceil(t_rows / 2)
// + 1) words; (0, 1) the per-lookup design. width % 4 == 0 (% stripe),
// n % width == 0, every pointer 16-byte aligned.
int tt_table_gather(const int32_t* tab, const int32_t* idx,
                    const int32_t* shift, int32_t* out, int64_t t_rows,
                    int width, int64_t n, int stripe, int holders,
                    void* stream) {
  const bool slab = (stripe == 16 || stripe == 8) && holders == 1;
  const bool pair = stripe == 8 && holders == 2 && t_rows >= 2;
  if (t_rows < 1 || width < 4 || width % 4 != 0 || n < 0 || n % width != 0 ||
      !(slab || pair || (stripe == 0 && holders == 1)) ||
      (stripe && (width % stripe != 0 || t_rows > INT32_MAX)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return shift ? gather_path<true>(tab, idx, shift, out, t_rows, width, n,
                                   stripe, holders, st)
               : gather_path<false>(tab, idx, shift, out, t_rows, width, n,
                                    stripe, holders, st);
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
// in a block's shared memory. path 0: bulk copies; 1: warp copies.
int tt_segment_copy(const int32_t* src, const int32_t* starts,
                    const int32_t* lens, const int32_t* outpos, int32_t* out,
                    int64_t nseg, int64_t length, int inflight, int path,
                    void* stream) {
  if (nseg < 0 || length < 4 || length % 4 != 0 || inflight < 1 ||
      inflight > kMaxInflight || length * 4 >= kMaxCopyBytes ||
      (path != 0 && path != 1))
    return cudaErrorInvalidValue;
  if (nseg == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1)
    return segment_warp(src, starts, lens, outpos, out, nseg, length,
                        inflight, st);
  const uint32_t bytes = uint32_t(length * 4);
  const size_t smem = size_t(inflight) * bytes;
  unsigned grid;
  const cudaError_t e = grid_for(segment_copy_kernel, 32, smem, nseg, &grid);
  if (e != cudaSuccess) return e;
  segment_copy_kernel<<<grid, 32, smem, st>>>(src, starts, lens, outpos, out,
                                              nseg, bytes, inflight);
  return cudaGetLastError();
}

}  // extern "C"
