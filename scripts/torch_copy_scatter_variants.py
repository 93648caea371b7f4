#!/usr/bin/env python3
"""Designs for ``stream_copy`` and ``table_scatter``, timed on the card.

    python3 scripts/torch_copy_scatter_variants.py [--reps 7] [--out DIR]

The first kernels for these two probes lost to a PyTorch call:
``stream_copy`` to ``out.copy_(x)`` and ``table_scatter`` (set, add) to
``scatter_`` and ``scatter_reduce_``. This script keeps those kernels as
they were (``original``), in its own source (``SOURCE``), beside the
designs tried against them, and times all of them in one process on one
card, beside the library's own (``ops/probes.py``) and the PyTorch
calls.

The copy at the probes' shapes, (524288, 128) and (2^21, 128) int32:
the original kernel (one int4 a thread an iteration, grid-stride,
streaming hints); ``unroll U``: U int4 loads a thread, all issued before
the stores, with and without the streaming hints, over a resident grid
or one tile a block; ``tile U x TB``: one tile of TB threads x U int4s a
block, plain loads and stores, the streaming hints (``hints``), or loads
asking L2 for 256 B around each miss (``L2::256B``, also read-only and
not kept in L1); ``bulk``: ``cp.async.bulk`` global -> shared stages on
mbarriers drained shared -> global by bulk stores, one thread a block,
over a resident grid or one chunk a block. It also disassembles the
original copy (``cuobjdump -sass``) and counts its loop's loads and
stores, to say whether nvcc kept more than one load in flight a
thread.

The scatter, 2^26 updates in each mode: idx and val (524288, 128) into a
(4096, 128) table (the probe's shape, where the library takes stripes of
8), then into (4096, 12) and (10000, 128) tables (where it takes stripes
of 4), each design that takes the shape: the original kernel (a global atomic or store an update, after the
table's memset); ``flush C``: a block a stripe of C columns and a range
of idx rows, its slab of the stripe in shared memory (shared atomics, or
stores for set), then the slab's nonzero cells flushed into the zeroed
table with one global atomic or store each; ``cluster C K``: the K
blocks of a stripe in one thread-block cluster, the slabs reduced
through distributed shared memory and every cell written once with a
plain store, no memset.

Every variant is held to its plain version first (the copy equal, the
scatter equal for max and add and ``scatter_set_ok`` for set), also at
ragged shapes. Each case times every variant twice, in order then
reversed, the best of both, each time by ``probes._time`` (the best of
``--reps`` samples of 5 calls back to back behind an untimed one, so the
host's dispatch of a call hides under the card's work). Prints the
card's name and power limit, one line a case, then the records as one
JSON line (with ``--out``, also DIR/torch_copy_scatter_variants.json and
the copy's SASS in DIR/copy_original.sass). Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {
constexpr int kThreads = 256;
constexpr int kSlabThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kMaxStages = 8;

template <class K>
cudaError_t resident(K kernel, int threads, size_t smem, int64_t* out) {
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
  *out = int64_t(sms) * per_sm;
  return cudaSuccess;
}

// ------------------------------------------ the original stream_copy
__global__ void copy_original(const int32_t* __restrict__ x,
                          int32_t* __restrict__ out, int64_t n) {
  const int64_t n4 = n / 4;
  const int4* x4 = reinterpret_cast<const int4*>(x);
  int4* o4 = reinterpret_cast<int4*>(out);
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nt = int64_t(gridDim.x) * blockDim.x;
  for (int64_t q = tid; q < n4; q += nt) __stcs(o4 + q, __ldcs(x4 + q));
  const int64_t t = n4 * 4 + tid;
  if (t < n) out[t] = x[t];
}

// U int4 loads a thread, all issued before the stores; tiles of
// kThreads * U int4s, a block's threads on neighbouring vectors
template <int U, bool kHints>
__global__ void __launch_bounds__(kThreads)
    copy_unroll(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                int64_t n) {
  const int64_t n4 = n / 4;
  const int4* x4 = reinterpret_cast<const int4*>(x);
  int4* o4 = reinterpret_cast<int4*>(out);
  constexpr int64_t kTile = int64_t(kThreads) * U;
  for (int64_t base = int64_t(blockIdx.x) * kTile; base < n4;
       base += int64_t(gridDim.x) * kTile) {
    int4 v[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t q = base + k * kThreads + threadIdx.x;
      v[k] = make_int4(0, 0, 0, 0);
      if (q < n4) v[k] = kHints ? __ldcs(x4 + q) : x4[q];
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t q = base + k * kThreads + threadIdx.x;
      if (q < n4) {
        if (kHints)
          __stcs(o4 + q, v[k]);
        else
          o4[q] = v[k];
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4)
    out[n4 * 4 + threadIdx.x] = x[n4 * 4 + threadIdx.x];
}

// kLoad 0: plain int4 loads; 1: __ldcs (and __stcs for the stores);
// 2: ld.global.L2::256B (L2 fetches 256 B around each miss); 3:
// ld.global.nc.L1::no_allocate.L2::256B
template <int kLoad>
__device__ __forceinline__ int4 load4(const int4* p) {
  int4 v;
  if (kLoad == 2)
    asm volatile("ld.global.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
  else if (kLoad == 3)
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::256B.v4.s32 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
  else if (kLoad == 1)
    v = __ldcs(p);
  else
    v = *p;
  return v;
}

// one tile of TB * U int4s a block (the grid covers the array), the U
// loads of a thread issued before its stores
template <int U, int TB, int kLoad>
__global__ void __launch_bounds__(TB)
    copy_tile(const int32_t* __restrict__ x, int32_t* __restrict__ out,
              int64_t n) {
  const int64_t n4 = n / 4;
  const int4* x4 = reinterpret_cast<const int4*>(x);
  int4* o4 = reinterpret_cast<int4*>(out);
  constexpr int64_t kTile = int64_t(TB) * U;
  for (int64_t base = int64_t(blockIdx.x) * kTile; base < n4;
       base += int64_t(gridDim.x) * kTile) {
    int4 v[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t q = base + k * TB + threadIdx.x;
      v[k] = q < n4 ? load4<kLoad>(x4 + q) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t q = base + k * TB + threadIdx.x;
      if (q < n4) {
        if (kLoad == 1)
          __stcs(o4 + q, v[k]);
        else
          o4[q] = v[k];
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4)
    out[n4 * 4 + threadIdx.x] = x[n4 * 4 + threadIdx.x];
}

template <int U, int TB, int kLoad>
cudaError_t copy_tiled(const int32_t* x, int32_t* out, int64_t n,
                       cudaStream_t st) {
  const int64_t tile = int64_t(TB) * U;
  int64_t need = (n / 4 + tile - 1) / tile;
  if (need < 1) need = 1;
  if (need > 0x7fffffff) need = 0x7fffffff;
  copy_tile<U, TB, kLoad><<<unsigned(need), TB, 0, st>>>(x, out, n);
  return cudaGetLastError();
}

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

// chunks of stage_bytes, chunk c = blockIdx.x + i * gridDim.x, `stages`
// in flight; the last < 16 bytes by block 0's thread
__global__ void __launch_bounds__(32)
    copy_bulk(const int32_t* __restrict__ x, int32_t* __restrict__ out,
              int64_t n, uint32_t stage_bytes, int stages) {
  extern __shared__ __align__(128) uint8_t buf[];
  __shared__ __align__(8) uint64_t bar[kMaxStages];
  if (threadIdx.x != 0) return;
  const int64_t body = n * 4 / 16 * 16;
  const int64_t chunks = (body + stage_bytes - 1) / stage_bytes;
  const char* src = reinterpret_cast<const char*>(x);
  char* dst = reinterpret_cast<char*>(out);
  for (int s = 0; s < stages; ++s) mbar_init(&bar[s]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  auto size_of = [&](int64_t c) {
    const int64_t left = body - c * stage_bytes;
    return uint32_t(left < int64_t(stage_bytes) ? left : stage_bytes);
  };
  int64_t next = blockIdx.x, issued = 0;
  auto issue = [&] {
    const int s = int(issued % stages);
    bulk_load(buf + size_t(s) * stage_bytes, src + next * stage_bytes,
              size_of(next), &bar[s]);
    ++issued;
    next += gridDim.x;
  };
  while (issued < stages && next < chunks) issue();
  const int lag = stages > 1 ? 1 : 0;
  int64_t c = blockIdx.x;
  for (int64_t done = 0; done < issued; ++done, c += gridDim.x) {
    const int s = int(done % stages);
    mbar_wait(&bar[s], uint32_t((done / stages) & 1));
    bulk_store(dst + c * stage_bytes, buf + size_t(s) * stage_bytes,
               size_of(c));
    if (done >= lag && next < chunks) {
      if (lag)
        bulk_wait_read<1>();
      else
        bulk_wait_read<0>();
      issue();
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  if (blockIdx.x == 0)
    for (int64_t t = body / 4; t < n; ++t) out[t] = x[t];
}

// ---------------------------------------- the original table_scatter
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
__global__ void scatter_original(const int32_t* __restrict__ idx,
                             const int32_t* __restrict__ val,
                             int32_t* __restrict__ tab, int width,
                             int64_t n4) {
  const int w4 = width / 4;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  const int4* v4 = reinterpret_cast<const int4*>(val);
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t q = tid; q < n4; q += int64_t(gridDim.x) * blockDim.x) {
    const int4 k = __ldcs(i4 + q);
    const int4 v = __ldcs(v4 + q);
    const int64_t j = (q % w4) * 4;
    put<kMode>(tab + int64_t(k.x) * width + j, v.x);
    put<kMode>(tab + int64_t(k.y) * width + j + 1, v.y);
    put<kMode>(tab + int64_t(k.z) * width + j + 2, v.z);
    put<kMode>(tab + int64_t(k.w) * width + j + 3, v.w);
  }
}

// ---------------------------------------------------- the slab designs
// The block's slab: its stripe's C columns of every table row, column
// by column with a stride of t_rows + 1 words (cell (r, c) at
// c * ld + r), zeroed, then updated by idx rows [r0, r1).
template <int kMode, int C>
__device__ void fill_slab(int32_t* slab, int ld,
                          const int32_t* __restrict__ idx,
                          const int32_t* __restrict__ val, int width,
                          int stripe, int64_t r0, int64_t r1) {
  for (int i = threadIdx.x; i < C * ld; i += blockDim.x) slab[i] = 0;
  __syncthreads();
  constexpr int Q = C / 4;
  const int64_t units = (r1 - r0) * Q;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  const int4* v4 = reinterpret_cast<const int4*>(val);
  const int w4 = width / 4;
  for (int64_t u0 = threadIdx.x; u0 < units;
       u0 += int64_t(blockDim.x) * kUnroll) {
    int4 k[kUnroll], v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t u = u0 + int64_t(j) * blockDim.x;
      k[j] = v[j] = make_int4(0, 0, 0, 0);
      if (u < units) {
        const int64_t at = (r0 + u / Q) * w4 + stripe * Q + u % Q;
        k[j] = __ldcs(i4 + at);
        v[j] = __ldcs(v4 + at);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
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
}

// (a) block (stripe, range) = blockIdx.x % stripes, / stripes; the
// slab's nonzero cells into the zeroed table
template <int kMode, int C>
__global__ void __launch_bounds__(kSlabThreads)
    scatter_flush(const int32_t* __restrict__ idx,
                  const int32_t* __restrict__ val, int32_t* __restrict__ tab,
                  int width, int t_rows, int64_t rows, int stripes,
                  int ranges) {
  extern __shared__ int4 slab4[];
  int32_t* slab = reinterpret_cast<int32_t*>(slab4);
  const int ld = t_rows + 1;
  const int s = int(blockIdx.x % stripes), r = int(blockIdx.x / stripes);
  fill_slab<kMode, C>(slab, ld, idx, val, width, s, rows * r / ranges,
                      rows * (r + 1) / ranges);
  for (int i = threadIdx.x; i < t_rows * C; i += blockDim.x) {
    const int row = i / C, c = i % C;
    const int32_t v = slab[c * ld + row];
    if (v != 0) put<kMode>(tab + int64_t(row) * width + s * C + c, v);
  }
}

// (b) the K blocks of a stripe in one cluster; block rank q reduces rows
// [q T / K, (q + 1) T / K) of the K slabs and writes every cell
template <int kMode, int C>
__global__ void __launch_bounds__(kSlabThreads)
    scatter_cluster(const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ val,
                    int32_t* __restrict__ tab, int width, int t_rows,
                    int64_t rows) {
  extern __shared__ int4 slab4[];
  int32_t* slab = reinterpret_cast<int32_t*>(slab4);
  const int ld = t_rows + 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = int(cluster.num_blocks());
  const int q = int(cluster.block_rank());
  const int s = int(blockIdx.x) / K;
  fill_slab<kMode, C>(slab, ld, idx, val, width, s, rows * q / K,
                      rows * (q + 1) / K);
  cluster.sync();
  const int lo = t_rows * q / K, hi = t_rows * (q + 1) / K;
  for (int i = threadIdx.x; i < (hi - lo) * C; i += blockDim.x) {
    const int row = lo + i / C, c = i % C;
    uint32_t acc = 0u;
    for (int b = 0; b < K; ++b) {
      const int32_t v = cluster.map_shared_rank(slab, b)[c * ld + row];
      if (kMode == 0)
        acc = acc != 0u ? acc : uint32_t(v);
      else if (kMode == 1)
        acc = uint32_t(max(int32_t(acc), v));
      else
        acc += uint32_t(v);
    }
    tab[int64_t(row) * width + s * C + c] = int32_t(acc);
  }
  cluster.sync();  // no block leaves while another reads its slab
}

template <class Kern, class... Args>
cudaError_t launch_cluster(Kern kernel, unsigned blocks, unsigned cluster,
                           size_t smem, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kSlabThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int kMode, int C>
cudaError_t scatter_variant(int design, int cluster, const int32_t* idx,
                            const int32_t* val, int32_t* tab, int width,
                            int t_rows, int64_t rows, cudaStream_t st) {
  const size_t smem = size_t(C) * (t_rows + 1) * 4;
  const int stripes = width / C;
  if (design == 1) {
    auto* kernel = scatter_flush<kMode, C>;
    int64_t fit;
    const cudaError_t e = resident(kernel, kSlabThreads, smem, &fit);
    if (e != cudaSuccess) return e;
    const int ranges = int(fit / stripes > 1 ? fit / stripes : 1);
    kernel<<<unsigned(stripes * ranges), kSlabThreads, smem, st>>>(
        idx, val, tab, width, t_rows, rows, stripes, ranges);
    return cudaGetLastError();
  }
  return launch_cluster(scatter_cluster<kMode, C>,
                        unsigned(stripes * cluster), unsigned(cluster), smem,
                        st, idx, val, tab, width, t_rows, rows);
}

template <int kMode>
cudaError_t scatter_mode(int design, int stripe, int cluster,
                         const int32_t* idx, const int32_t* val,
                         int32_t* tab, int width, int t_rows, int64_t rows,
                         cudaStream_t st) {
  if (design == 0) {
    auto* kernel = scatter_original<kMode>;
    const int64_t n4 = rows * width / 4;
    int64_t fit;
    const cudaError_t e = resident(kernel, kThreads, 0, &fit);
    if (e != cudaSuccess) return e;
    const int64_t need = (n4 + kThreads - 1) / kThreads;
    kernel<<<unsigned(need < fit ? need : fit), kThreads, 0, st>>>(
        idx, val, tab, width, n4);
    return cudaGetLastError();
  }
  if (stripe == 8)
    return scatter_variant<kMode, 8>(design, cluster, idx, val, tab, width,
                                     t_rows, rows, st);
  return scatter_variant<kMode, 4>(design, cluster, idx, val, tab, width,
                                   t_rows, rows, st);
}

template <int U, bool kHints>
cudaError_t copy_unrolled(const int32_t* x, int32_t* out, int64_t n,
                          int persistent, cudaStream_t st) {
  auto* kernel = copy_unroll<U, kHints>;
  const int64_t tile = int64_t(kThreads) * U;
  int64_t need = (n / 4 + tile - 1) / tile, fit;
  if (need < 1) need = 1;
  const cudaError_t e = resident(kernel, kThreads, 0, &fit);
  if (e != cudaSuccess) return e;
  kernel<<<unsigned(persistent && fit < need ? fit : need), kThreads, 0,
           st>>>(x, out, n);
  return cudaGetLastError();
}
}  // namespace

extern "C" {

// design 0: the original; 1: unroll U (hints, persistent); 2: bulk stages
// (persistent, or one chunk a block); 3: one tile of `persistent`
// threads x U a block, `hints` the load flavour (load4)
int tv_copy(int design, int unroll, int hints, int persistent,
            uint32_t stage_bytes, int stages, const int32_t* x,
            int32_t* out, int64_t n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return n < 0 ? int(cudaErrorInvalidValue) : 0;
  if (design == 0) {
    int64_t fit;
    const cudaError_t e = resident(copy_original, kThreads, 0, &fit);
    if (e != cudaSuccess) return e;
    const int64_t need = (n / 4 + kThreads) / kThreads;
    copy_original<<<unsigned(need < fit ? need : fit), kThreads, 0, st>>>(
        x, out,
                                                                     n);
    return cudaGetLastError();
  }
  if (design == 2) {
    if (stages < 1 || stages > kMaxStages || stage_bytes % 16 ||
        stage_bytes >= (1u << 20))
      return cudaErrorInvalidValue;
    const size_t smem = size_t(stages) * stage_bytes;
    int64_t fit;
    const cudaError_t e = resident(copy_bulk, 32, smem, &fit);
    if (e != cudaSuccess) return e;
    const int64_t chunks = (n * 4 / 16 * 16 + stage_bytes - 1) / stage_bytes;
    // persistent: the resident blocks; else one chunk a block
    const int64_t grid = chunks < fit || !persistent
                             ? (chunks > 0 ? chunks : 1) : fit;
    copy_bulk<<<unsigned(grid), 32, smem, st>>>(x, out, n, stage_bytes,
                                                stages);
    return cudaGetLastError();
  }
  if (design == 3) {
#define TT(U, TB, L) \
  if (unroll == U && persistent == TB && hints == L) \
    return copy_tiled<U, TB, L>(x, out, n, st);
    TT(1, 128, 0) TT(1, 256, 0) TT(1, 512, 0) TT(2, 128, 0) TT(2, 256, 0)
    TT(2, 512, 0) TT(4, 128, 0) TT(4, 512, 0) TT(4, 1024, 0) TT(16, 256, 0)
    TT(2, 256, 2) TT(4, 256, 2) TT(4, 256, 3) TT(8, 256, 2) TT(8, 256, 3)
    TT(1, 1024, 0) TT(1, 256, 1) TT(1, 512, 1) TT(1, 1024, 1) TT(2, 256, 1)
    TT(2, 512, 1) TT(1, 512, 2)
#undef TT
    return cudaErrorInvalidValue;
  }
#define TV(U, H) \
  if (unroll == U && hints == H) \
    return copy_unrolled<U, H>(x, out, n, persistent, st);
  TV(1, 1) TV(1, 0) TV(2, 1) TV(2, 0) TV(4, 1) TV(4, 0) TV(8, 1) TV(8, 0)
#undef TV
  return cudaErrorInvalidValue;
}

// design 0: the original (tab zeroed by the caller); 1: slab flush (tab
// zeroed by the caller); 2: cluster of `cluster` blocks a stripe (every
// cell written). mode 0 set, 1 max, 2 add; stripe 4 or 8 columns.
int tv_scatter(int design, int mode, int stripe, int cluster,
               const int32_t* idx, const int32_t* val, int32_t* tab,
               int width, int t_rows, int64_t rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design != 0 && (width % stripe || (stripe != 4 && stripe != 8)))
    return cudaErrorInvalidValue;
  switch (mode) {
    case 0:
      return scatter_mode<0>(design, stripe, cluster, idx, val, tab, width,
                             t_rows, rows, st);
    case 1:
      return scatter_mode<1>(design, stripe, cluster, idx, val, tab, width,
                             t_rows, rows, st);
    case 2:
      return scatter_mode<2>(design, stripe, cluster, idx, val, tab, width,
                             t_rows, rows, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
"""

#: the copy designs: (label, design, unroll, hints, persistent,
#: stage_bytes, stages)
COPIES = (
    ("original", 0, 0, 0, 0, 0, 0),
    *((f"unroll {u}{' hints' if h else ''}", 1, u, h, 1, 0, 0)
      for u in (1, 2, 4, 8) for h in (1, 0)),
    *((f"unroll {u}{' hints' if h else ''} one tile a block", 1, u, h, 0, 0,
       0) for u in (4, 8) for h in (1, 0)),
    *((f"bulk {kb} KB x {s}", 2, 0, 0, 1, kb * 1024, s)
      for kb, s in ((16, 4), (32, 4), (64, 3), (16, 8))),
    *((f"bulk {kb} KB one chunk a block", 2, 0, 0, 0, kb * 1024, 1)
      for kb in (16, 32, 64)),
    *((f"tile {u} x {tb}", 3, u, 0, tb, 0, 0)
      for u, tb in ((1, 128), (1, 256), (1, 512), (2, 128), (2, 256),
                    (2, 512), (4, 128), (4, 512), (4, 1024), (16, 256))),
    ("tile 1 x 1024", 3, 1, 0, 1024, 0, 0),
    *((f"tile {u} x {tb} hints", 3, u, 1, tb, 0, 0)
      for u, tb in ((1, 256), (1, 512), (1, 1024), (2, 256), (2, 512))),
    ("tile 1 x 512 L2::256B", 3, 1, 2, 512, 0, 0),
    ("tile 2 x 256 L2::256B", 3, 2, 2, 256, 0, 0),
    *((f"tile {u} x 256 {name}", 3, u, load, 256, 0, 0)
      for u in (4, 8) for load, name in ((2, "L2::256B"),
                                         (3, "nc no_allocate L2::256B"))),
)
#: the scatter designs: (label, design, stripe, cluster)
SCATTERS = (
    ("original", 0, 0, 0),
    ("flush C=8", 1, 8, 0),
    ("flush C=4", 1, 4, 0),
    ("cluster C=8 K=8", 2, 8, 8),
    ("cluster C=4 K=8", 2, 4, 8),
)

#: the timed scatters, (table rows, width), 2^26 updates each: the
#: probe's shape, where the library takes stripes of 8, then two where
#: it takes stripes of 4 (a width off 8; a table past 7,263 rows)
TIMED_SCATTERS = ((4096, 128), (4096, 12), (10000, 128))


def sass_summary(lib_path: str, out_dir: str | None) -> str:
    """The original copy as nvcc compiled it: its loads and stores in
    the loop, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    blocks = re.split(r"\n\s*Function : ", text)
    body = next(b for b in blocks if b.startswith("_Z") and "copy_original" in
                b.split("\n", 1)[0])
    if out_dir:
        with open(os.path.join(out_dir, "copy_original.sass"), "w") as f:
            f.write(body)
    lines = body.splitlines()
    ldg = [ln for ln in lines if re.search(r"\bLDG\.", ln)]
    stg = [ln for ln in lines if re.search(r"\bSTG\.", ln)]
    branches = [ln for ln in lines if re.search(r"\bBRA\b", ln)]
    wide = [ln for ln in ldg if ".128" in ln]
    return (f"the original stream_copy's SASS: {len(ldg)} LDG "
            f"({len(wide)} of 128 bits), {len(stg)} STG, {len(branches)} "
            f"BRA; LDG lines: "
            + " | ".join(_instruction(ln) for ln in ldg)
            + "; STG lines: " + " | ".join(_instruction(ln) for ln in stg)
            + "; BRA lines: " + " | ".join(_instruction(ln)
                                          for ln in branches))


def _instruction(line: str) -> str:
    """A SASS line's address and instruction, without its encoding."""
    m = re.search(r"/\*([0-9a-f]{4})\*/\s*([^;]*);", line)
    return f"{m.group(1)}: {m.group(2).strip()}" if m else line.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", help="directory for the records (JSON, SASS)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_copy_scatter_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from titan_tpu_torch import build
    from titan_tpu_torch.ops import probes as PR

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    os.makedirs(build.CUDA_BUILD_DIR, exist_ok=True)
    with tempfile.NamedTemporaryFile("w", suffix=".cu",
                                     dir=build.CUDA_BUILD_DIR,
                                     delete=False) as f:
        f.write(SOURCE)
    try:
        lib_path = build.build_shared(
            f.name, [build.nvcc()] + build.NVCC_FLAGS, build.CUDA_BUILD_DIR,
            "copy_scatter_variants")
    finally:
        os.remove(f.name)
    lib = ctypes.CDLL(lib_path)
    p, i64, i32, u32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_uint32)
    lib.tv_copy.argtypes = [i32, i32, i32, i32, u32, i32, p, p, i64, p]
    lib.tv_scatter.argtypes = [i32, i32, i32, i32, p, p, p, i32, i32, i64,
                               p]
    lib.tv_copy.restype = lib.tv_scatter.restype = i32
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    sass = sass_summary(lib_path, args.out)
    print(sass, flush=True)

    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def copy_fn(v, x, out):
        if v == "library":
            return lambda: PR._launch_stream_copy(x)
        if v == "out.copy_(x)":
            return lambda: out.copy_(x)
        if v == "clone":
            return lambda: x.clone()
        _, design, u, h, pers, sb, st = next(c for c in COPIES if c[0] == v)

        def fn():
            err = lib.tv_copy(design, u, h, pers, sb, st, x.data_ptr(),
                              out.data_ptr(), x.numel(), stream)
            if err:
                raise RuntimeError(f"copy {v}: CUDA error {err}")
            return out
        return fn

    def scatter_fn(v, idx, val, t_rows, mode, tab, acc):
        m = PR.SCATTER_MODES.index(mode)
        if v == "library":
            return lambda: PR._launch_table_scatter(idx, val, t_rows, mode)
        if v == "torch":
            if mode == "set":
                return lambda: acc.scatter_(0, idx, val)
            red = {"max": "amax", "add": "sum"}[mode]
            return lambda: acc.scatter_reduce_(0, idx, val, red)
        _, design, stripe, cluster = next(c for c in SCATTERS if c[0] == v)

        def fn():
            if design != 2:       # as the wrapper would: a zeroed table
                tab.zero_()
            err = lib.tv_scatter(design, m, stripe, cluster, idx.data_ptr(),
                                 val.data_ptr(), tab.data_ptr(),
                                 idx.shape[1], t_rows, idx.shape[0], stream)
            if err:
                raise RuntimeError(f"scatter {v} {mode}: CUDA error {err}")
            return tab
        return fn

    def fits(v, t_rows, width):
        """Whether a scatter design takes the shape: the slab designs
        need whole stripes and a slab within a block's shared memory."""
        c = next((c for c in SCATTERS if c[0] == v), None)
        return c is None or c[2] == 0 or (
            width % c[2] == 0 and 4 * c[2] * (t_rows + 1) <= PR.SHARED_BYTES)

    copy_names = [c[0] for c in COPIES] + ["library", "out.copy_(x)",
                                           "clone"]
    scatter_names = [c[0] for c in SCATTERS] + ["library", "torch"]
    records = []
    # ragged checks first: sizes off every unroll and stage size
    for n in (1, 3, 4, 5, 1023, 1000003, 4096 * 257 + 7, 2**20 + 4):
        x = ri(-2**31, 2**31 - 1, (n,))
        for v in copy_names[:-2]:
            out = torch.full_like(x, -1)
            got = copy_fn(v, x, out)()
            torch.cuda.synchronize()
            if not torch.equal(got, x):
                raise RuntimeError(f"copy {v} differs at n={n}")
    for t_rows, width, rows in ((4096, 128, 1001), (7, 128, 3),
                                (4096, 12, 999), (100, 132, 5001),
                                (8, 4, 17)):
        idx = ri(0, t_rows, (rows, width))
        for mode in PR.SCATTER_MODES:
            lo, hi = (-2**31, 2**31 - 1) if mode == "add" else (-100, 100)
            val = ri(lo, hi, (rows, width))
            want = PR.table_scatter_reference(idx, val, t_rows, mode)
            for v in scatter_names[:-1]:
                if not fits(v, t_rows, width):
                    continue
                tab = torch.full((t_rows, width), -7, dtype=torch.int32,
                                 device=dev)
                got = scatter_fn(v, idx, val, t_rows, mode, tab, None)()
                torch.cuda.synchronize()
                ok = PR.scatter_set_ok(got, idx, val) if mode == "set" \
                    else torch.equal(got, want)
                if not ok:
                    raise RuntimeError(f"scatter {v} {mode} differs at "
                                       f"T={t_rows}, W={width}, rows={rows}")
    print("every variant equal to its plain version at the ragged shapes",
          flush=True)

    for rows in (524288, 2**21):
        x = ri(-2**31, 2**31 - 1, (rows, PR.WIDTH))
        out = torch.empty_like(x)
        for v in copy_names:
            out.fill_(-1)
            got = copy_fn(v, x, out)()
            torch.cuda.synchronize()
            if not torch.equal(got, x):
                raise RuntimeError(f"copy {v} differs at ({rows}, 128)")
        ms = {}
        for v in (*copy_names, *reversed(copy_names)):
            t = PR._time(copy_fn(v, x, out), args.reps)[0]
            ms[v] = min(ms.get(v, t), t)
        b = PR.bound_ms(PR.copy_bytes(x.numel()))
        records.append({"case": f"copy ({rows}, 128)", "bound_ms": b,
                        "ms": ms, "share": {k: b / t for k, t in ms.items()}})
        print(f"copy ({rows}, 128) on {card}: bound {b:.4f} ms; " + "; ".join(
            f"{k} {t:.4f} ms ({100 * b / t:.1f}%)" for k, t in ms.items()),
            flush=True)
        del x, out
        torch.cuda.empty_cache()

    for t_rows, width in TIMED_SCATTERS:
        rows = 2**26 // width
        idx = ri(0, t_rows, (rows, width))
        names = [v for v in scatter_names if fits(v, t_rows, width)]
        case = f"({rows}, {width}) into ({t_rows}, {width})"
        for mode in PR.SCATTER_MODES:
            val = ri(0, 100, idx.shape)
            tab = torch.empty((t_rows, width), dtype=torch.int32, device=dev)
            acc = torch.zeros_like(tab)
            want = PR.table_scatter_reference(idx, val, t_rows, mode)
            for v in names[:-1]:
                got = scatter_fn(v, idx, val, t_rows, mode, tab, acc)()
                torch.cuda.synchronize()
                ok = PR.scatter_set_ok(got, idx, val) if mode == "set" \
                    else torch.equal(got, want)
                if not ok:
                    raise RuntimeError(f"scatter {v} {mode} differs at "
                                       f"{case}")
            ms = {}
            for v in (*names, *reversed(names)):
                t = PR._time(scatter_fn(v, idx, val, t_rows, mode, tab, acc),
                             args.reps)[0]
                ms[v] = min(ms.get(v, t), t)
            b = PR.bound_ms(PR.scatter_bytes(idx.numel(), t_rows))
            records.append({"case": f"scatter {mode} {case}",
                            "library_stripe": PR.scatter_path(t_rows, width),
                            "bound_ms": b, "ms": ms,
                            "share": {k: b / t for k, t in ms.items()},
                            "g_updates_s": {k: idx.numel() / t / 1e6
                                            for k, t in ms.items()}})
            print(f"scatter {mode} {case} on {card} (the library's stripe "
                  f"{PR.scatter_path(t_rows, width)}): bound {b:.4f} ms; "
                  + "; ".join(f"{k} {t:.4f} ms ({100 * b / t:.1f}%, "
                              f"{idx.numel() / t / 1e6:.1f} G updates/s)"
                              for k, t in ms.items()), flush=True)
        del idx, val, tab, acc, want
        torch.cuda.empty_cache()
    summary = {"card": card, "sass": sass, "cases": records}
    if args.out:
        with open(os.path.join(args.out, "torch_copy_scatter_variants.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
