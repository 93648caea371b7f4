#!/usr/bin/env python3
"""Two questions about ``table_gather``'s design, timed on the card.

    python3 scripts/torch_gather_variants.py [--reps 7] [--out DIR]

1. Does staging a small table in shared memory beat reading it through
   the read-only path (``__ldg``, the library's design)? Timed at the
   8-row tile (the gather and the bit lookup) and at 448 rows.
2. Is the gather from a table beyond L2 short of lookups in flight? Each
   thread takes ``groups`` int4s of idx (4 lookups each), issues all
   their loads, then stores them; groups 1 is the library's design.
   Timed at the 8 MB table (L2) and the 256 MB one (HBM), beside
   ``torch.gather`` on the same inputs.

The variants are one templated kernel kept in this script (``SOURCE``);
the library's own ``table_gather`` is timed beside them. Every variant
is held to ``torch.gather`` first. Shapes are the probes' (idx [2^21,
128]). Prints the card's name and power limit, one line a case, then
the records as one JSON line (also DIR/torch_gather_variants.json with
``--out``). Exits 1 without a card.
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
#include <cstdint>

namespace {
constexpr int kThreads = 256;

template <bool kStaged, bool kBits, int kGroups>
__global__ void gather_variant(const int32_t* __restrict__ tab,
                               const int32_t* __restrict__ idx,
                               const int32_t* __restrict__ shift,
                               int32_t* __restrict__ out, int64_t t_words,
                               int width, int64_t n4) {
  extern __shared__ int4 staged[];
  const int32_t* st = reinterpret_cast<const int32_t*>(staged);
  if (kStaged) {
    const int4* t4 = reinterpret_cast<const int4*>(tab);
    for (int64_t i = threadIdx.x; i < t_words / 4; i += blockDim.x)
      staged[i] = __ldg(t4 + i);
    __syncthreads();
  }
  const int w4 = width / 4;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  const int4* s4 = reinterpret_cast<const int4*>(shift);
  int4* o4 = reinterpret_cast<int4*>(out);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t q0 = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       q0 < n4; q0 += stride * kGroups) {
    int4 k[kGroups], v[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int64_t q = q0 + g * stride;
      k[g] = q < n4 ? __ldcs(i4 + q) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int64_t j = ((q0 + g * stride) % w4) * 4;
      if (kStaged) {
        v[g].x = st[int64_t(k[g].x) * width + j];
        v[g].y = st[int64_t(k[g].y) * width + j + 1];
        v[g].z = st[int64_t(k[g].z) * width + j + 2];
        v[g].w = st[int64_t(k[g].w) * width + j + 3];
      } else {
        v[g].x = __ldg(tab + int64_t(k[g].x) * width + j);
        v[g].y = __ldg(tab + int64_t(k[g].y) * width + j + 1);
        v[g].z = __ldg(tab + int64_t(k[g].z) * width + j + 2);
        v[g].w = __ldg(tab + int64_t(k[g].w) * width + j + 3);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int64_t q = q0 + g * stride;
      if (q >= n4) break;
      if (kBits) {
        const int4 s = __ldcs(s4 + q);
        v[g].x = (v[g].x >> s.x) & 1;
        v[g].y = (v[g].y >> s.y) & 1;
        v[g].z = (v[g].z >> s.z) & 1;
        v[g].w = (v[g].w >> s.w) & 1;
      }
      __stcs(o4 + q, v[g]);
    }
  }
}

template <bool kStaged, bool kBits, int kGroups>
int launch(const int32_t* tab, const int32_t* idx, const int32_t* shift,
           int32_t* out, int64_t t_words, int width, int64_t n4,
           cudaStream_t st) {
  auto* kernel = gather_variant<kStaged, kBits, kGroups>;
  const size_t smem = kStaged ? size_t(t_words) * 4 : 0;
  int dev, sms, per_sm;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(smem));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const int64_t need = (n4 + int64_t(kThreads) * kGroups - 1) /
                       (int64_t(kThreads) * kGroups);
  const int64_t resident = int64_t(sms) * per_sm;
  const unsigned grid = unsigned(need < resident ? need : resident);
  kernel<<<grid, kThreads, smem, st>>>(tab, idx, shift, out, t_words, width,
                                       n4);
  return cudaGetLastError();
}
}  // namespace

extern "C" int tv_gather(int staged, int groups, const int32_t* tab,
                         const int32_t* idx, const int32_t* shift,
                         int32_t* out, int64_t t_rows, int width, int64_t n,
                         void* stream) {
  const int64_t t_words = t_rows * width, n4 = n / 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TV(S, B, G) \
  if (staged == S && (shift != nullptr) == B && groups == G) \
    return launch<S, B, G>(tab, idx, shift, out, t_words, width, n4, st);
  TV(true, false, 1) TV(true, true, 1) TV(false, false, 1) TV(false, true, 1)
  TV(false, false, 2) TV(false, false, 4) TV(false, false, 8)
#undef TV
  return int(cudaErrorInvalidValue);
}
"""


def best_ms(fn, reps: int) -> float:
    """The best of ``reps`` CUDA-event times of ``fn()`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return min(ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", help="directory for the records (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gather_variants: no CUDA device", file=sys.stderr)
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
        lib = ctypes.CDLL(build.build_shared(
            f.name, [build.nvcc()] + build.NVCC_FLAGS, build.CUDA_BUILD_DIR,
            "gather_variants"))
    finally:
        os.remove(f.name)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tv_gather.argtypes = [i32, i32, p, p, p, p, i64, i32, i64, p]
    lib.tv_gather.restype = i32

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    rows, width = 2**21, PR.WIDTH
    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = (("8-row tile", 8, False, ((1, 1), (0, 1), "library")),
             ("bit lookup, 8-row tile", 8, True,
              ((1, 1), (0, 1), "library")),
             ("448-row table", 448, False, ((1, 1), (0, 1), "library")),
             ("8 MB table (L2)", 16384, False,
              ((0, 1), (0, 2), (0, 4), "library", "torch.gather")),
             ("256 MB table (HBM)", 2**19, False,
              ((0, 1), (0, 2), (0, 4), (0, 8), "library", "torch.gather")))
    records = []
    for label, t_rows, bits, variants in cases:
        tab = torch.randint(0, 2**20, (t_rows, width), generator=gen,
                            device=dev, dtype=torch.int32)
        idx = torch.randint(0, t_rows, (rows, width), generator=gen,
                            device=dev, dtype=torch.int32)
        shift = torch.randint(0, 32, idx.shape, generator=gen, device=dev,
                              dtype=torch.int32) if bits else None
        want = PR.table_gather_reference(tab, idx, shift)
        out = torch.empty_like(idx)

        def call(v):
            if v == "library":
                return lambda: PR._launch_table_gather(tab, idx, shift)
            if v == "torch.gather":
                return lambda: torch.gather(tab, 0, idx, out=out)
            staged, groups = v

            def fn():
                err = lib.tv_gather(staged, groups, tab.data_ptr(),
                                    idx.data_ptr(), PR._ptr(shift),
                                    out.data_ptr(), t_rows, width,
                                    idx.numel(), stream)
                if err:
                    raise RuntimeError(f"gather_variant {v}: CUDA error "
                                       f"{err}")
                return out
            return fn
        names = {v: v if isinstance(v, str) else
                 f"{'staged' if v[0] else 'ldg'} groups={v[1]}"
                 for v in variants}
        ms = {}
        for v in variants:
            got = call(v)()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{label}: {names[v]} differs from "
                                   "torch.gather")
        # each variant twice, in order then reversed; the best of both
        for v in (*variants, *reversed(variants)):
            t = best_ms(call(v), args.reps)
            ms[names[v]] = min(ms.get(names[v], t), t)
        n = idx.numel()
        rec = {"case": label, "t_rows": t_rows, "bits": bits, "lookups": n,
               "ms": ms, "g_lookup_s": {k: n / t / 1e6
                                         for k, t in ms.items()}}
        records.append(rec)
        print(f"{label} on {card}: " + "; ".join(
            f"{k} {t:.4f} ms ({n / t / 1e6:.2f} G lookups/s, "
            f"{32 * n / t / 1e6:.1f} GB/s of lookup sectors)"
            for k, t in ms.items()), flush=True)
        del tab, idx, shift, want, out
        torch.cuda.empty_cache()
    summary = {"card": card, "cases": records}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_gather_variants.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
