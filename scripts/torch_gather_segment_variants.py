#!/usr/bin/env python3
"""Designs for ``table_gather`` and ``segment_copy``, timed on the card.

    python3 scripts/torch_gather_segment_variants.py [--reps 7] [--out DIR]

The first kernels for these two probes ran far from their bounds:
``table_gather`` at 29-31% from tables in L2, a little behind
``torch.gather``, since a lookup costs a 32-byte L2 sector for its 4
bytes; ``segment_copy`` at 48-77%, one bulk copy (``cp.async.bulk``) and
its mbarrier round trip a segment. This script keeps the original
gather as it was (``original``) in its own source (``SOURCE``), beside
every design tried against it, and times all of them in one process on
one card, beside the library's own (``ops/probes.py``: the wrapper, its
design by shape; ``segment_copy``'s path 0 is the original bulk-copy
kernel unchanged) and the PyTorch calls.

The gather at the probes' shapes (idx (524288, 128) from the 2 MB table,
idx (2^21, 128) from tables of 2048, 8192 and 16384 rows, the 8-row tile
with and without the bit lookup, the 256 MB table) and at T = 64-1024
and 12000 (where the per-lookup and slab designs trade places):

- ``original``: a thread each 4 lookups over a grid of the resident blocks,
  table loads by ``__ldg``; ``flat``: the same, one int4 of idx a thread
  over as many blocks as the array needs (the library's per-lookup
  kernel);
- ``slab C=c parts=p <hints> [lock L]``: a block holds stripe b % S of
  c columns of the table (of its rows, split over ``p`` blocks, each
  writing the words whose index falls in its rows) in shared memory and
  streams its range of idx rows; idx read by ``ld.global.L2::128B``,
  ``L2::256B`` or ``__ldcs``, out stored plainly or by ``__stcs``; with
  ``lock L`` the grid runs in clusters of L neighbouring blocks that
  pass a cluster barrier every step, so they share the lines of idx
  and out while these are in L2 (the library's slab: c of 16 or 8,
  parts 1, ``L2::128B``, plain stores, lock 8);
- ``cluster K=k pow2``: a stripe of 8 held across the shared memory of
  a cluster of k blocks (spans of a power of two), lookups into the
  others' rows through distributed shared memory; ``cluster K=2``: two
  blocks, any span (the library's pair);
- ``library``, ``torch.gather``.

The segment copy at the probes' cases (probe3_dma's four, probe3d's
five) and at 1-8 KB segments with 8 in flight: ``bulk`` (path 0, the original
kernel), ``warp`` (path 1: a warp copies ``inflight`` segments at a
time, one int4 a lane a step, with the streaming hints), ``warp plain``
(the same without the hints), ``library`` (its path by length) and the
PyTorch call computing the same output.

Every design is held to its plain version first at ragged shapes (one
that fails to launch or differs is dropped, and listed with why; the
library's own never is), then at each timed shape (and the PyTorch
call's output too). Each case times every design twice, in order then
reversed, the best of both, each time by ``probes._time`` (the best of
``--reps`` samples of 5 calls back to back behind an untimed one).
Prints the card's name and power limit, one line a case, every ptxas
line, then the records as one JSON line (with ``--out``, also
DIR/torch_gather_segment_variants.json). Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
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
constexpr int kFlatThreads = 1024;
constexpr int kSlabThreads = 1024;
constexpr int kSlabUnroll = 4;
constexpr int kWarpCopyThreads = 256;

template <class K>
cudaError_t resident(K kernel, int threads, size_t smem, int64_t* out) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // set at every launch: a cluster launch of the same kernel may have
  // lowered it, and a launch asking for more than it is refused
  if (e == cudaSuccess && smem > 0)
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

__device__ __forceinline__ int4 bits_of(int4 v, int4 s) {
  return make_int4((v.x >> s.x) & 1, (v.y >> s.y) & 1, (v.z >> s.z) & 1,
                   (v.w >> s.w) & 1);
}

// ---------------------------------------- the original table_gather kernel
template <bool kBits>
__global__ void gather_original(const int32_t* __restrict__ tab,
                                const int32_t* __restrict__ idx,
                                const int32_t* __restrict__ shift,
                                int32_t* __restrict__ out, int width,
                                int64_t n4) {
  const int w4 = width / 4;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  const int4* s4 = reinterpret_cast<const int4*>(shift);
  int4* o4 = reinterpret_cast<int4*>(out);
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nt = int64_t(gridDim.x) * blockDim.x;
  for (int64_t q = tid; q < n4; q += nt) {
    const int4 k = __ldcs(i4 + q);
    const int64_t j = (q % w4) * 4;
    int4 v;
    v.x = __ldg(tab + int64_t(k.x) * width + j);
    v.y = __ldg(tab + int64_t(k.y) * width + j + 1);
    v.z = __ldg(tab + int64_t(k.z) * width + j + 2);
    v.w = __ldg(tab + int64_t(k.w) * width + j + 3);
    if (kBits) {
      const int4 s = __ldcs(s4 + q);
      v.x = (v.x >> s.x) & 1;
      v.y = (v.y >> s.y) & 1;
      v.z = (v.z >> s.z) & 1;
      v.w = (v.w >> s.w) & 1;
    }
    __stcs(o4 + q, v);
  }
}

// ------------------------------- flat: one int4 of idx a thread, full grid
template <bool kBits>
__global__ void __launch_bounds__(kFlatThreads)
    gather_flat(const int32_t* __restrict__ tab,
                const int32_t* __restrict__ idx,
                const int32_t* __restrict__ shift, int32_t* __restrict__ out,
                int width, int64_t n4) {
  const int64_t q = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n4) return;
  const int w4 = width / 4;
  const int4 k = __ldcs(reinterpret_cast<const int4*>(idx) + q);
  const int64_t j = (q % w4) * 4;
  int4 v;
  v.x = __ldg(tab + int64_t(k.x) * width + j);
  v.y = __ldg(tab + int64_t(k.y) * width + j + 1);
  v.z = __ldg(tab + int64_t(k.z) * width + j + 2);
  v.w = __ldg(tab + int64_t(k.w) * width + j + 3);
  if (kBits) v = bits_of(v, __ldcs(reinterpret_cast<const int4*>(shift) + q));
  __stcs(reinterpret_cast<int4*>(out) + q, v);
}

// ---------------- slab x: the library's slab kernel with other hints and
// blocks held in lockstep. kLoad 1: idx by ld.global.L2::128B; 2:
// ld.global.L2::256B; 3: __ldcs. kStore 0: plain stores; 1: __stcs.
// Blocks b = (range * S + stripe) * parts + part: a stripe's parts side
// by side, then the stripes of a range. With lock > 1 the grid runs in
// clusters of `lock` consecutive blocks (the parts of a stripe, or
// neighbouring stripes, which share idx and out sectors) that pass a
// cluster barrier every kSlabThreads * kSlabUnroll units, so no block
// of a cluster runs more than one step ahead of the others and a sector
// that they share is read or completed while it is still in L2.
template <int kLoad>
__device__ __forceinline__ int4 load_idx(const int4* p) {
  int4 v;
  if (kLoad == 1)
    asm volatile("ld.global.L2::128B.v4.s32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
  else if (kLoad == 2)
    asm volatile("ld.global.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
  else
    v = __ldcs(p);
  return v;
}

template <int kStore, class T>
__device__ __forceinline__ void store_out(T* p, T v) {
  if (kStore)
    __stcs(p, v);
  else
    *p = v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <bool kBits, int C, int kLoad, int kStore>
__global__ void __launch_bounds__(kSlabThreads)
    gather_slab_x(const int32_t* __restrict__ tab,
                  const int32_t* __restrict__ idx,
                  const int32_t* __restrict__ shift,
                  int32_t* __restrict__ out, int width, int t_rows,
                  int64_t rows, int parts, int ranges, int lock) {
  extern __shared__ int4 slab4[];
  int32_t* slab = reinterpret_cast<int32_t*>(slab4);
  const int stripes = width / C;
  const int part = int(blockIdx.x % parts);
  const int stripe = int(blockIdx.x / parts % stripes);
  const int range = int(blockIdx.x / parts / stripes);
  const int t0 = int(int64_t(t_rows) * part / parts);
  const int span = int(int64_t(t_rows) * (part + 1) / parts) - t0;
  const int ld = span + 1;
  constexpr int Q = C / 4;
  const int w4 = width / 4;
  const int4* t4 = reinterpret_cast<const int4*>(tab);
  for (int i = threadIdx.x; i < span * Q; i += blockDim.x) {
    const int r = i / Q, q = i % Q;
    const int4 v = __ldg(t4 + int64_t(t0 + r) * w4 + stripe * Q + q);
    int32_t* cell = slab + q * 4 * ld + r;
    cell[0] = v.x;
    cell[ld] = v.y;
    cell[2 * ld] = v.z;
    cell[3 * ld] = v.w;
  }
  __syncthreads();
  const int64_t r0 = rows * range / ranges;
  const int64_t units = (rows * (range + 1) / ranges - r0) * Q;
  const int64_t step = int64_t(blockDim.x) * kSlabUnroll;
  const int64_t iters = (units + step - 1) / step;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  const int4* s4 = reinterpret_cast<const int4*>(shift);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (int64_t it = 0; it < iters; ++it) {
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
        k[j] = load_idx<kLoad>(i4 + at[j]);
        if (kBits) s[j] = load_idx<kLoad>(s4 + at[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSlabUnroll; ++j) {
      const int64_t u = u0 + int64_t(j) * blockDim.x;
      if (u >= units) continue;
      const int32_t* col = slab + int(u % Q) * 4 * ld;
      if (parts == 1) {
        int4 v = make_int4(col[k[j].x], col[ld + k[j].y],
                           col[2 * ld + k[j].z], col[3 * ld + k[j].w]);
        if (kBits) v = bits_of(v, s[j]);
        store_out<kStore>(o4 + at[j], v);
      } else {
        const int kk[4] = {k[j].x, k[j].y, k[j].z, k[j].w};
        const int ss[4] = {s[j].x, s[j].y, s[j].z, s[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = kk[e] - t0;
          if (unsigned(r) < unsigned(span)) {
            const int32_t w = col[e * ld + r];
            store_out<kStore>(out + at[j] * 4 + e,
                              kBits ? (w >> ss[e]) & 1 : w);
          }
        }
      }
    }
    if (lock > 1) cluster_arrive();
  }
  if (lock > 1 && iters > 0) cluster_wait();
}

// a stripe of 8 over a cluster of 2 blocks: rank q holds table rows
// [q * span, q * span + span), span = ceil(T / 2), any T up to 14526
template <bool kBits, int kLoad>
__global__ void __launch_bounds__(kSlabThreads)
    gather_cluster2(const int32_t* __restrict__ tab,
                    const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ shift,
                    int32_t* __restrict__ out, int width, int t_rows,
                    int64_t rows, int ranges) {
  constexpr int C = 8, Q = 2;
  extern __shared__ int4 slab4[];
  int32_t* slab = reinterpret_cast<int32_t*>(slab4);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = int(cl.block_rank());
  const int cid = int(blockIdx.x / 2);
  const int stripes = width / C;
  const int stripe = cid % stripes, range = cid / stripes;
  const int span = (t_rows + 1) / 2, ld = span + 1;
  const int t0 = rank * span;
  const int mine = rank ? t_rows - span : span;
  const int w4 = width / 4;
  const int4* t4 = reinterpret_cast<const int4*>(tab);
  for (int i = threadIdx.x; i < mine * Q; i += blockDim.x) {
    const int r = i / Q, q = i % Q;
    const int4 v = __ldg(t4 + int64_t(t0 + r) * w4 + stripe * Q + q);
    int32_t* cell = slab + q * 4 * ld + r;
    cell[0] = v.x;
    cell[ld] = v.y;
    cell[2 * ld] = v.z;
    cell[3 * ld] = v.w;
  }
  cl.sync();
  const int32_t* halves[2] = {cl.map_shared_rank(slab, 0u),
                              cl.map_shared_rank(slab, 1u)};
  const int64_t sub = int64_t(range) * 2 + rank, subs = int64_t(ranges) * 2;
  const int64_t r0 = rows * sub / subs;
  const int64_t units = (rows * (sub + 1) / subs - r0) * Q;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  const int4* s4 = reinterpret_cast<const int4*>(shift);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (int64_t u0 = threadIdx.x; u0 < units;
       u0 += int64_t(blockDim.x) * kSlabUnroll) {
    int4 k[kSlabUnroll], s[kSlabUnroll];
#pragma unroll
    for (int j = 0; j < kSlabUnroll; ++j) {
      const int64_t u = u0 + int64_t(j) * blockDim.x;
      k[j] = s[j] = make_int4(0, 0, 0, 0);
      if (u < units) {
        const int64_t at = (r0 + u / Q) * w4 + stripe * Q + u % Q;
        k[j] = load_idx<kLoad>(i4 + at);
        if (kBits) s[j] = load_idx<kLoad>(s4 + at);
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
      __stcs(o4 + (r0 + u / Q) * w4 + stripe * Q + u % Q, v);
    }
  }
  cl.sync();  // no block leaves while another reads its slab
}

// ------------ cluster: a stripe of 8 over the K blocks of a cluster, rank
// q holding table rows [q * span, (q + 1) * span), span = 2^sh
template <bool kBits, int K>
__global__ void __launch_bounds__(kSlabThreads)
    gather_cluster(const int32_t* __restrict__ tab,
                   const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ shift,
                   int32_t* __restrict__ out, int width, int t_rows,
                   int64_t rows, int ranges, int sh) {
  constexpr int C = 8, Q = 2;
  extern __shared__ int4 slab4[];
  int32_t* slab = reinterpret_cast<int32_t*>(slab4);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = int(cl.block_rank());
  const int cid = int(blockIdx.x / K);
  const int stripes = width / C;
  const int stripe = cid % stripes, range = cid / stripes;
  const int span = 1 << sh, ld = span + 1;
  const int t0 = rank * span;
  const int mine = t_rows - t0 < span ? t_rows - t0 : span;
  const int w4 = width / 4;
  const int4* t4 = reinterpret_cast<const int4*>(tab);
  for (int i = threadIdx.x; i < mine * Q; i += blockDim.x) {
    const int r = i / Q, q = i % Q;
    const int4 v = __ldg(t4 + int64_t(t0 + r) * w4 + stripe * Q + q);
    int32_t* cell = slab + q * 4 * ld + r;
    cell[0] = v.x;
    cell[ld] = v.y;
    cell[2 * ld] = v.z;
    cell[3 * ld] = v.w;
  }
  cl.sync();
  const int64_t sub = int64_t(range) * K + rank, subs = int64_t(ranges) * K;
  const int64_t r0 = rows * sub / subs;
  const int64_t units = (rows * (sub + 1) / subs - r0) * Q;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  const int4* s4 = reinterpret_cast<const int4*>(shift);
  int4* o4 = reinterpret_cast<int4*>(out);
  const int mask = span - 1;
  for (int64_t u0 = threadIdx.x; u0 < units;
       u0 += int64_t(blockDim.x) * kSlabUnroll) {
    int4 k[kSlabUnroll], s[kSlabUnroll];
#pragma unroll
    for (int j = 0; j < kSlabUnroll; ++j) {
      const int64_t u = u0 + int64_t(j) * blockDim.x;
      k[j] = s[j] = make_int4(0, 0, 0, 0);
      if (u < units) {
        const int64_t at = (r0 + u / Q) * w4 + stripe * Q + u % Q;
        k[j] = __ldcs(i4 + at);
        if (kBits) s[j] = __ldcs(s4 + at);
      }
    }
#pragma unroll
    for (int j = 0; j < kSlabUnroll; ++j) {
      const int64_t u = u0 + int64_t(j) * blockDim.x;
      if (u >= units) continue;
      const int c0 = int(u % Q) * 4 * ld;
      int4 v;
      v.x = cl.map_shared_rank(slab, unsigned(k[j].x >> sh))
                [c0 + (k[j].x & mask)];
      v.y = cl.map_shared_rank(slab, unsigned(k[j].y >> sh))
                [c0 + ld + (k[j].y & mask)];
      v.z = cl.map_shared_rank(slab, unsigned(k[j].z >> sh))
                [c0 + 2 * ld + (k[j].z & mask)];
      v.w = cl.map_shared_rank(slab, unsigned(k[j].w >> sh))
                [c0 + 3 * ld + (k[j].w & mask)];
      if (kBits) v = bits_of(v, s[j]);
      __stcs(o4 + (r0 + u / Q) * w4 + stripe * Q + u % Q, v);
    }
  }
  cl.sync();  // no block leaves while another reads its slab
}

// ------------------------- warp plain: the warp copy without the hints
template <int G>
__global__ void __launch_bounds__(kWarpCopyThreads)
    segment_warp_plain(const int32_t* __restrict__ src,
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
      if (g < inflight && a >= 0 && q < length4) v[g] = s4[a + q];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int a = __shfl_sync(0xffffffffu, to, g);
      if (g < inflight && a >= 0 && q < length4) o4[a + q] = v[g];
    }
  }
}

// The config of a launch in clusters of `cluster` blocks.
template <class Kern>
cudaError_t cluster_config(Kern kernel, unsigned cluster, size_t smem,
                           cudaStream_t st, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster);
  cfg->blockDim = dim3(kSlabThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The row ranges of `per_range` blocks each that fit on the card at once
// in clusters of cfg's size.
template <class Kern>
cudaError_t cluster_ranges(Kern kernel, const cudaLaunchConfig_t* cfg,
                           unsigned cluster, int per_range, int* ranges) {
  int fit = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&fit, kernel, cfg);
  if (e != cudaSuccess) return e;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const int blocks = fit * int(cluster);
  *ranges = blocks / per_range > 1 ? blocks / per_range : 1;
  return cudaSuccess;
}

template <bool kBits, int K>
cudaError_t launch_gather_cluster(const int32_t* tab, const int32_t* idx,
                                  const int32_t* shift, int32_t* out,
                                  int width, int t_rows, int64_t rows,
                                  int sh, cudaStream_t st) {
  auto* kernel = gather_cluster<kBits, K>;
  const size_t smem = size_t(8) * ((size_t(1) << sh) + 1) * 4;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int ranges = 0;
  const int per_range = (width / 8) * K;
  cudaError_t e = cluster_config(kernel, K, smem, st, &cfg, attr);
  if (e == cudaSuccess)
    e = cluster_ranges(kernel, &cfg, K, per_range, &ranges);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3(unsigned(per_range * ranges));
  e = cudaLaunchKernelEx(&cfg, kernel, tab, idx, shift, out, width, t_rows,
                         rows, ranges, sh);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool kBits, int kLoad>
cudaError_t launch_gather_cluster2(const int32_t* tab, const int32_t* idx,
                                   const int32_t* shift, int32_t* out,
                                   int width, int t_rows, int64_t rows,
                                   cudaStream_t st) {
  auto* kernel = gather_cluster2<kBits, kLoad>;
  const size_t smem = size_t(8) * ((t_rows + 1) / 2 + 1) * 4;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int ranges = 0;
  const int per_range = (width / 8) * 2;
  cudaError_t e = cluster_config(kernel, 2, smem, st, &cfg, attr);
  if (e == cudaSuccess)
    e = cluster_ranges(kernel, &cfg, 2, per_range, &ranges);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3(unsigned(per_range * ranges));
  e = cudaLaunchKernelEx(&cfg, kernel, tab, idx, shift, out, width, t_rows,
                         rows, ranges);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool kBits, int C, int kLoad, int kStore>
cudaError_t launch_slab_x(const int32_t* tab, const int32_t* idx,
                          const int32_t* shift, int32_t* out, int width,
                          int t_rows, int64_t rows, int parts, int lock,
                          cudaStream_t st) {
  auto* kernel = gather_slab_x<kBits, C, kLoad, kStore>;
  const size_t smem =
      size_t(C) * ((t_rows + parts - 1) / parts + 1) * 4;
  const int per_range = (width / C) * parts;
  int ranges = 0;
  if (lock > 1) {
    if (per_range % lock) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t e = cluster_config(kernel, unsigned(lock), smem, st, &cfg,
                                   attr);
    if (e == cudaSuccess)
      e = cluster_ranges(kernel, &cfg, unsigned(lock), per_range, &ranges);
    if (e != cudaSuccess) return e;
    cfg.gridDim = dim3(unsigned(per_range * ranges));
    e = cudaLaunchKernelEx(&cfg, kernel, tab, idx, shift, out, width, t_rows,
                           rows, parts, ranges, lock);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  int64_t fit;
  const cudaError_t e = resident(kernel, kSlabThreads, smem, &fit);
  if (e != cudaSuccess) return e;
  ranges = int(fit) / per_range > 1 ? int(fit) / per_range : 1;
  kernel<<<unsigned(per_range * ranges), kSlabThreads, smem, st>>>(
      tab, idx, shift, out, width, t_rows, rows, parts, ranges, 1);
  return cudaGetLastError();
}

// design 0: the original kernel; 1: flat; 2: slab x (stripe, load, store,
// parts, lock); 3: a cluster of `lock` (2 or 4) blocks a stripe of 8,
// spans of a power of 2; 4: a cluster of 2 blocks a stripe of 8, any span
template <bool kBits>
cudaError_t gather_variant(int design, int stripe, int load, int store,
                           int parts, int lock, const int32_t* tab,
                           const int32_t* idx, const int32_t* shift,
                           int32_t* out, int64_t t_rows, int width,
                           int64_t n, cudaStream_t st) {
  const int64_t n4 = n / 4, rows = n / width;
  if (design == 0) {
    auto* kernel = gather_original<kBits>;
    int64_t fit;
    const cudaError_t e = resident(kernel, kThreads, 0, &fit);
    if (e != cudaSuccess) return e;
    const int64_t need = (n4 + kThreads - 1) / kThreads;
    kernel<<<unsigned(need < fit ? need : fit), kThreads, 0, st>>>(
        tab, idx, shift, out, width, n4);
    return cudaGetLastError();
  }
  if (design == 1) {
    gather_flat<kBits><<<unsigned((n4 + kFlatThreads - 1) / kFlatThreads),
                         kFlatThreads, 0, st>>>(tab, idx, shift, out, width,
                                                n4);
    return cudaGetLastError();
  }
  if (design == 2 && stripe && width % stripe == 0 && parts >= 1) {
#define TV_SLAB(C, L, S)                                                     \
  if (stripe == C && load == L && store == S)                                \
    return launch_slab_x<kBits, C, L, S>(tab, idx, shift, out, width,        \
                                         int(t_rows), rows, parts, lock, st);
#define TV_SLABS(C) \
  TV_SLAB(C, 1, 0) TV_SLAB(C, 1, 1) TV_SLAB(C, 2, 0) TV_SLAB(C, 2, 1) \
  TV_SLAB(C, 3, 0) TV_SLAB(C, 3, 1)
    TV_SLABS(16) TV_SLABS(8) TV_SLABS(4)
#undef TV_SLABS
#undef TV_SLAB
  }
  if (design == 3 && width % 8 == 0) {
    int sh = 0;
    while ((int64_t(lock) << sh) < t_rows) ++sh;
    if (lock == 2)
      return launch_gather_cluster<kBits, 2>(tab, idx, shift, out, width,
                                             int(t_rows), rows, sh, st);
    if (lock == 4)
      return launch_gather_cluster<kBits, 4>(tab, idx, shift, out, width,
                                             int(t_rows), rows, sh, st);
  }
  if (design == 4 && width % 8 == 0) {
    if (load == 1)
      return launch_gather_cluster2<kBits, 1>(tab, idx, shift, out, width,
                                              int(t_rows), rows, st);
    return launch_gather_cluster2<kBits, 3>(tab, idx, shift, out, width,
                                            int(t_rows), rows, st);
  }
  return cudaErrorInvalidValue;
}

template <int G>
cudaError_t launch_warp_plain(const int32_t* src, const int32_t* starts,
                              const int32_t* lens, const int32_t* outpos,
                              int32_t* out, int64_t nseg, int64_t length,
                              int inflight, cudaStream_t st) {
  constexpr int kWarps = kWarpCopyThreads / 32;
  const int64_t warps = (nseg + inflight - 1) / inflight;
  segment_warp_plain<G><<<unsigned((warps + kWarps - 1) / kWarps),
                          kWarpCopyThreads, 0, st>>>(
      src, starts, lens, outpos, out, nseg, length / 4, inflight);
  return cudaGetLastError();
}
}  // namespace

extern "C" {

const char* tv_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// the gather designs of gather_variant
int tv_gather(int design, int stripe, int load, int store, int parts,
              int lock, const int32_t* tab, const int32_t* idx,
              const int32_t* shift, int32_t* out, int64_t t_rows, int width,
              int64_t n, void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return shift ? gather_variant<true>(design, stripe, load, store, parts,
                                      lock, tab, idx, shift, out, t_rows,
                                      width, n, st)
               : gather_variant<false>(design, stripe, load, store, parts,
                                       lock, tab, idx, shift, out, t_rows,
                                       width, n, st);
}

// the warp copy without the streaming hints
int tv_segment_plain(const int32_t* src, const int32_t* starts,
                     const int32_t* lens, const int32_t* outpos,
                     int32_t* out, int64_t nseg, int64_t length,
                     int inflight, void* stream) {
  if (nseg == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TV_WARP(G)                                                        \
  if (inflight <= G)                                                      \
    return launch_warp_plain<G>(src, starts, lens, outpos, out, nseg, \
                                length, inflight, st);
  TV_WARP(1) TV_WARP(2) TV_WARP(4) TV_WARP(8) TV_WARP(16) TV_WARP(32)
#undef TV_WARP
  return cudaErrorInvalidValue;
}

}  // extern "C"
"""

#: the gathers timed: (label, table rows, idx rows, bits, every
#: design or the few that place the per-lookup/slab switch)
TIMED_GATHERS = (
    ("2 MB table, idx (524288, 128)", 4096, 524288, False, True),
    ("T=2048 (1 MB), idx (2^21, 128)", 2048, 2**21, False, True),
    ("T=8192 (4 MB), idx (2^21, 128)", 8192, 2**21, False, True),
    ("T=16384 (8 MB), idx (2^21, 128)", 16384, 2**21, False, True),
    ("8-row tile, idx (2^21, 128)", 8, 2**21, False, True),
    ("bit lookup 8-row tile, (2^21, 128)", 8, 2**21, True, True),
    ("T=2^19 (256 MB, beyond L2), idx (2^21, 128)", 2**19, 2**21, False,
     True),
    *((f"T={t}, idx (2^21, 128)", t, 2**21, False, False)
      for t in (64, 256, 384, 512, 768, 1024, 12000)),
)
#: the extra segment lengths timed (words), 8 in flight, about 32 MB
#: each way
EXTRA_LENGTHS = (256, 512, 1024, 2048)
#: (load, store) of slab x: idx by L2::128B, L2::256B or __ldcs; out
#: plain or by __stcs
HINTS = {(3, 1): "ldcs stcs", (1, 0): "L2::128B plain",
         (1, 1): "L2::128B stcs", (2, 0): "L2::256B plain",
         (3, 0): "ldcs plain"}


#: the slab's stripe widths tried
SLAB_STRIPES = (16, 8, 4)


def slab_bytes(stripe: int, t_rows: int, parts: int = 1) -> int:
    """A slab's shared memory: ``stripe`` columns of the largest of
    ``parts`` row parts, each column padded by one word."""
    return 4 * stripe * (-(-t_rows // parts) + 1)


def gather_variants(t_rows: int, width: int, PR, every: bool = True
                    ) -> list[tuple]:
    """The gather designs that take a ``[t_rows, width]`` table: (label,
    design, stripe, load, store, parts, lock); with ``every`` False, the
    per-lookup ones and the slab's of 16 columns."""
    out = [("original", 0, 0, 0, 0, 1, 1), ("flat", 1, 0, 0, 0, 1, 1)]
    if 4 * t_rows * width > PR.L2_BYTES:
        return out
    for c in SLAB_STRIPES:
        parts = next((p for p in range(1, 9)
                      if slab_bytes(c, t_rows, p) <= PR.SHARED_BYTES),
                     None)
        if width % c or parts is None or (not every and c != 16):
            continue
        blocks = width // c * parts

        def slab(name, load, store, lock):
            return (f"slab C={c} parts={parts} {name}"
                    + (f" lock {lock}" if lock > 1 else ""), 2, c, load,
                    store, parts, lock)
        if not every:
            if parts == 1 and blocks % 8 == 0:
                out.append(slab(HINTS[1, 1], 1, 1, 8))
            continue
        hints = HINTS if parts == 1 else {(1, 1): HINTS[1, 1]}
        out += [slab(name, ld, st, 1) for (ld, st), name in hints.items()]
        locks = (2, 4, 8) if parts == 1 else (parts, 2 * parts)
        out += [slab(HINTS[1, 1], 1, 1, lk) for lk in locks
                if 1 < lk <= 8 and blocks % lk == 0]
        out += [slab(HINTS[1, 0], 1, 0, lk) for lk in (4, 8)
                if parts == 1 and blocks % lk == 0]
    if not every or width % 8:
        return out
    for k in (2, 4):
        span = 1
        while k * span < t_rows:
            span *= 2
        if t_rows > 4096 and slab_bytes(8, span) <= PR.SHARED_BYTES:
            out.append((f"cluster K={k} pow2", 3, 8, 3, 1, 1, k))
    if t_rows > 3631 and slab_bytes(8, t_rows, 2) <= PR.SHARED_BYTES:
        out += [(f"cluster K=2 {name}", 4, 8, ld, 1, 1, 2)
                for ld, name in ((3, "ldcs"), (1, "L2::128B"))]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", help="directory for the records (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gather_segment_variants: no CUDA device",
              file=sys.stderr)
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
            "gather_segment_variants")
    finally:
        os.remove(f.name)
    lib = ctypes.CDLL(lib_path)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tv_gather.argtypes = [i32] * 6 + [p, p, p, p, i64, i32, i64, p]
    lib.tv_segment_plain.argtypes = [p, p, p, p, p, i64, i64, i32, p]
    lib.tv_gather.restype = lib.tv_segment_plain.restype = i32
    lib.tv_error.argtypes, lib.tv_error.restype = [i32], ctypes.c_char_p
    klib = PR.kernel_library()
    with open(lib_path + ".log") as f:
        ptxas = f.read()
    with open(klib._name + ".log") as f:
        ptxas += f.read()
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def gather_fn(v, tab, idx, shift, out):
        if v == "library":
            return lambda: PR._launch_table_gather(tab, idx, shift)
        if v == "torch.gather":
            return lambda: torch.gather(tab, 0, idx, out=out)
        label, *knobs = v

        def fn():
            err = lib.tv_gather(*knobs, tab.data_ptr(), idx.data_ptr(),
                                PR._ptr(shift), out.data_ptr(),
                                tab.shape[0], tab.shape[1], idx.numel(),
                                stream)
            if err:
                raise RuntimeError(f"gather {label}: CUDA error {err} "
                                   f"({lib.tv_error(err).decode()})")
            return out
        return fn

    def segment_fn(v, src, starts, outpos, length, out_len, lens, inflight,
                   out):
        if v == "library":
            return lambda: PR._launch_segment_copy(
                src, starts, outpos, length, out_len, lens, inflight)

        def fn():
            if v == "warp plain":
                err = lib.tv_segment_plain(
                    src.data_ptr(), starts.data_ptr(), PR._ptr(lens),
                    outpos.data_ptr(), out.data_ptr(), starts.numel(),
                    length, inflight, stream)
            else:
                err = klib.tt_segment_copy(
                    src.data_ptr(), starts.data_ptr(), PR._ptr(lens),
                    outpos.data_ptr(), out.data_ptr(), starts.numel(),
                    length, inflight, {"bulk": 0, "warp": 1}[v], stream)
            if err:
                raise RuntimeError(f"segment {v}: CUDA error {err}")
            return out
        return fn

    def time_all(names, make):
        ms = {}
        for v in (*names, *reversed(names)):
            t = PR._time(make(v), args.reps)[0]
            key = v if isinstance(v, str) else v[0]
            ms[key] = min(ms.get(key, t), t)
        return ms

    # ragged checks first; a design that fails or differs is dropped,
    # with why, from what follows (the library's own never is)
    failed = {}
    for t_rows, width in ((8, 128), (449, 128), (2048, 128), (4096, 128),
                          (8192, 128), (16384, 128), (7263, 128),
                          (7264, 128), (29057, 128), (100, 12), (3, 4),
                          (9000, 8)):
        tab = ri(0, 2**20, (t_rows, width))
        for rows in (1, 1001, (1 << 16) + 5):
            idx = ri(0, t_rows, (rows, width))
            for shift in (None, ri(0, 32, (rows, width))):
                want = PR.table_gather_reference(tab, idx, shift)
                for v in gather_variants(t_rows, width, PR) + ["library"]:
                    name = v if isinstance(v, str) else v[0]
                    if name in failed:
                        continue
                    out = torch.full_like(idx, -1)
                    try:
                        got = gather_fn(v, tab, idx, shift, out)()
                        torch.cuda.synchronize()
                        why = None if torch.equal(got, want) else "differs"
                    except RuntimeError as e:
                        why = str(e)
                    if why and name == "library":
                        raise RuntimeError(f"gather library at T={t_rows}, "
                                           f"W={width}: {why}")
                    if why:
                        failed[name] = (f"T={t_rows}, W={width}, rows="
                                        f"{rows}, bits={shift is not None}: "
                                        f"{why}")
                        print(f"dropped gather {name}: {failed[name]}",
                              flush=True)
    pool = ri(0, 2**20, (1 << 24,))
    for length, n, f, dead in ((4, 1001, 8, False), (36, 1003, 3, True),
                               (128, 5001, 31, True), (128, 5003, 32, False),
                               (512, 999, 1, True), (1024, 333, 2, False),
                               (4096, 101, 8, True)):
        starts = ri(0, (len(pool) - length) // 4, (n,)) * 4
        outpos = torch.randperm(n, generator=gen, device=dev).to(
            torch.int32) * length
        lens = torch.where(torch.arange(n, device=dev) % 5 == 4, 0,
                           7).to(torch.int32) if dead else None
        want = PR.segment_copy_reference(pool, starts, outpos, length,
                                         n * length, lens)
        live = outpos if lens is None else outpos[lens > 0]
        at = (live.long()[:, None] + torch.arange(length, device=dev)
              ).reshape(-1)
        for v in ("bulk", "warp", "warp plain", "library"):
            out = torch.full((n * length,), -1, dtype=torch.int32,
                             device=dev)
            got = segment_fn(v, pool, starts, outpos, length, n * length,
                             lens, f, out)()
            torch.cuda.synchronize()
            if not torch.equal(got[at], want[at]):
                raise RuntimeError(f"segment {v} differs at L={length}, "
                                   f"n={n}, inflight={f}")
    print("every variant equal to its plain version at the ragged shapes",
          flush=True)
    del pool
    torch.cuda.empty_cache()

    records = []
    for label, t_rows, rows, bits, every in TIMED_GATHERS:
        tab = ri(0, 2**20, (t_rows, PR.WIDTH))
        idx = ri(0, t_rows, (rows, PR.WIDTH))
        shift = ri(0, 32, idx.shape) if bits else None
        out = torch.empty_like(idx)
        want = PR.table_gather_reference(tab, idx, shift)
        names = [v for v in gather_variants(t_rows, PR.WIDTH, PR, every)
                 if v[0] not in failed] + ["library"]
        if not bits:
            names.append("torch.gather")
        for v in names:
            out.fill_(-1)
            got = gather_fn(v, tab, idx, shift, out)()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"gather {v} differs at {label}")
        ms = time_all(names, lambda v: gather_fn(v, tab, idx, shift, out))
        n = idx.numel()
        b = PR.bound_ms(PR.gather_bytes(t_rows, n, bits=bits))
        path = PR.gather_path(t_rows, PR.WIDTH)
        records.append({"case": f"gather {label}", "library_path": path,
                        "bound_ms": b, "ms": ms,
                        "share": {k: b / t for k, t in ms.items()},
                        "g_lookups_s": {k: n / t / 1e6
                                        for k, t in ms.items()}})
        print(f"gather {label} on {card} (the library's path {path}): bound "
              f"{b:.4f} ms; " + "; ".join(
                  f"{k} {t:.4f} ms ({100 * b / t:.1f}%)"
                  for k, t in ms.items()), flush=True)
        del tab, idx, shift, out, want
        torch.cuda.empty_cache()

    cases = [(label, p) for kernel, label, p, _ in PR.PROBES
             if kernel == "segment_copy"]
    cases += [(f"L={4 * w} B nseg={2**23 // w} inflight=8",
               {"pool": 2**25, "deg": w, "pad": w, "nseg": 2**23 // w,
                "inflight": 8}) for w in EXTRA_LENGTHS]
    for label, p in cases:
        src, starts, outpos, length, out_len, lens, inflight, library, _ = \
            PR._segment_inputs(p, gen, dev)
        out = torch.empty(out_len, dtype=torch.int32, device=dev)
        want = PR.segment_copy_reference(src, starts, outpos, length,
                                         out_len, lens)
        live = outpos if lens is None else outpos[lens > 0]
        at = (live.long()[:, None] + torch.arange(length, device=dev)
              ).reshape(-1)
        names = ["bulk", "warp", "warp plain", "library"]
        for v in names:
            out.fill_(-1)
            got = segment_fn(v, src, starts, outpos, length, out_len, lens,
                             inflight, out)()
            torch.cuda.synchronize()
            if not torch.equal(got[at], want[at]):
                raise RuntimeError(f"segment {v} differs at {label}")

        def make(v):
            if v == "torch":
                return library
            return segment_fn(v, src, starts, outpos, length, out_len, lens,
                              inflight, out)
        if library is not None:
            if not torch.equal(library().reshape(-1)[at], want[at]):
                raise RuntimeError(f"segment: the PyTorch call differs at "
                                   f"{label}")
            names.append("torch")
        ms = time_all(names, make)
        b = PR.bound_ms(PR.segment_bytes(starts, outpos, length, lens))
        records.append({"case": f"segment {label}", "length_bytes":
                        4 * length, "library_path": PR.segment_path(length),
                        "bound_ms": b, "ms": ms,
                        "share": {k: b / t for k, t in ms.items()}})
        print(f"segment {label} ({4 * length} B) on {card} (the library's "
              f"path {PR.segment_path(length)}): bound {b:.4f} ms; "
              + "; ".join(f"{k} {t:.4f} ms ({100 * b / t:.1f}%)"
                          for k, t in ms.items()), flush=True)
        del src, starts, outpos, lens, out, want
        torch.cuda.empty_cache()
    ptx = [ln.strip() for ln in ptxas.splitlines()
           if "registers" in ln or "spill" in ln or "Compiling" in ln]
    print("ptxas: " + " | ".join(ptx), flush=True)
    summary = {"card": card, "cases": records, "failed": failed,
               "ptxas": ptx}
    if args.out:
        with open(os.path.join(args.out,
                               "torch_gather_segment_variants.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
