#!/usr/bin/env python3
"""Where the port's vertex-program engine spends a PageRank run and a
batched BFS run on the card, on chip_smoke.py's engine graph.

    python3 scripts/torch_engine_breakdown.py [--out DIR]

Builds or loads chip_smoke.py's Graph500 scale-22 graph (the port's cache
under .bench_cache/torch), makes its snapshot (``from_chunked_csr``) and
uploads it. After one warm-up run of PageRank (alpha 0.85, 20
supersteps) through ``GPUGraphComputer.run`` it measures:

* the host wall time of a run, and the device time of each superstep
  (CUDA events recorded at each call of the engine's
  ``segment_combine``, so a superstep runs from one combine to the next);
* one run under ``torch.profiler``: the device's busy and idle shares
  and the device time by kernel name (``seg_scan``'s kernel as
  ``match_ms``; its scratch memset is listed apart).

Then the same two measurements of ``GPUGraphComputer.run_batched`` for
chip_smoke.py's K = 16 BFS sources (a superstep runs from one K-row
combine, ``sorted_segment_combine``, to the next).

With ``--out``, the summaries (JSON) and the Chrome traces are written to
DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel of csrc/seg_scan.cu
SCAN_KERNELS = ("seg_scan_kernel",)


def superstep_times(E, run, hook: str = "segment_combine"
                    ) -> tuple[float, list[float]]:
    """One run with a CUDA event at each call of the engine's combine
    ``hook``; returns (host wall ms, device ms between consecutive
    combines)."""
    real, marks = getattr(E, hook), []

    def marked(*a, **k):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return real(*a, **k)

    setattr(E, hook, marked)
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    finally:
        setattr(E, hook, real)
    return wall, [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the summary and trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_engine_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from chip_smoke import (BATCH_K, ENGINE_SCALE, EDGE_FACTOR, SEED,
                            card_line, sample_sources)
    from torch_bfs_breakdown import device_profile
    from titan_tpu_torch.models import bfs as MB
    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.olap import engine as E
    from titan_tpu_torch.olap import graph500 as G
    from titan_tpu_torch.olap import snapshot as SN

    card = card_line()
    hg = G.load_or_build(ENGINE_SCALE, EDGE_FACTOR, seed=SEED, verbose=False)
    snap = SN.from_chunked_csr(hg)
    comp = E.GPUGraphComputer(snapshot=snap)
    E.device_graph(snap, comp.device)

    def run():
        return MP.run(comp, 0.85, 20, 0.0, snap)

    srcs = sample_sources(hg["deg"], BATCH_K)

    def batch():
        return comp.run_batched(MB.BFS(),
                                [{"source_dense": s} for s in srcs])

    for name, fn, hook in (
            ("pagerank", run, "segment_combine"),
            (f"bfs_batch_k{BATCH_K}", batch, "sorted_segment_combine")):
        fn()                                                # warm-up
        wall, steps = superstep_times(E, fn, hook)
        print(f"s{ENGINE_SCALE} {name} on {card}: host wall {wall:.3f} ms "
              f"for {len(steps) + 1} supersteps; device ms between "
              f"consecutive combines: " + ", ".join(f"{s:.3f}"
                                                    for s in steps))
        prof = device_profile(
            fn, args.out and os.path.join(
                args.out, f"{name}_s{ENGINE_SCALE}_trace.json"),
            SCAN_KERNELS)
        if args.out:
            with open(os.path.join(args.out, f"{name}_s{ENGINE_SCALE}_"
                                   "breakdown.json"), "w") as f:
                json.dump({"scale": ENGINE_SCALE, "card": card,
                           "wall_ms": wall, "superstep_ms": steps,
                           "profile": prof}, f, indent=1)
        print(f"profiled {name} run on {card}: wall {prof['wall_ms']:.3f} "
              f"ms under the profiler, device busy "
              f"{prof['device_busy_ms']:.3f} ms (idle share "
              f"{prof['device_idle_share']:.3f}), seg_scan "
              f"{prof['match_ms']:.3f} ms")
        for row in prof["top"]:
            print(f"  {row['ms']:10.3f} ms {row['calls']:6d}x  {row['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
