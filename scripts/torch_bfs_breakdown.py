#!/usr/bin/env python3
"""Where the port's BFS time goes on the card, on chip_smoke.py's graph.

    python3 scripts/torch_bfs_breakdown.py [--out DIR]

Builds or loads chip_smoke.py's Graph500 graph (scale 26; the port's
cache under .bench_cache/torch, which chip_smoke.py fills), uploads it
and takes chip_smoke.py's sources (bench.py's sampling rule). After one
warm-up BFS it measures, for each source:

* the device time of each level step of ``models/bfs_hybrid`` (CUDA
  events recorded around every call of ``_head_loop``, ``_td_step``,
  ``_bu_open``, ...; a step's time includes any idle gap inside it);

and, for the first source, one run under ``torch.profiler``: the device's
busy and idle shares and the device time by kernel name. With
``--out``, the summary (JSON) and the Chrome trace are written to DIR.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ("_head_loop", "_td_step", "_frontier_of", "_bu_open", "_bu_rounds",
         "_bu_exhaust", "_level_stats", "_endgame")
# the kernel of csrc/frontier_round.cu (one launch a call)
ROUND_KERNELS = ("frontier_round_kernel",)


def step_times(P, g, src):
    """One BFS with CUDA events around every level-step call made by the
    driver (a step's own inner calls, such as ``_td_step``'s
    ``_level_stats``, count in that step); returns (wall ms, levels,
    {step: [ms, calls]})."""
    marks = []
    depth = [0]
    real = {name: getattr(P, name) for name in STEPS}

    def timed(name):
        def call(*a, **k):
            if depth[0]:
                return real[name](*a, **k)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            depth[0] += 1
            try:
                out = real[name](*a, **k)
            finally:
                depth[0] -= 1
            e1.record()
            marks.append((name, e0, e1))
            return out
        return call

    for name in STEPS:
        setattr(P, name, timed(name))
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        _, levels = P.frontier_bfs_hybrid(g, src, return_device=True)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    finally:
        for name in STEPS:
            setattr(P, name, real[name])
    per = collections.defaultdict(lambda: [0.0, 0])
    for name, e0, e1 in marks:
        per[name][0] += e0.elapsed_time(e1)
        per[name][1] += 1
    return wall, levels, dict(per)


def device_profile(fn, trace: str | None, match=()) -> dict:
    """fn() under torch.profiler: wall, device busy and idle share, and
    device time by kernel name (``match_ms``: the kernels whose names
    hold one of ``match``). The Chrome trace is written to ``trace`` (a
    temporary file when None)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        if trace:
            os.makedirs(os.path.dirname(trace), exist_ok=True)
        path = trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_name[e["name"]] += e.get("dur", 0)
            calls[e["name"]] += 1
    busy = sum(by_name.values())
    matched = sum(us for name, us in by_name.items()
                  if any(k in name for k in match))
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / wall_us,
            "match_ms": matched / 1e3,
            "top": [{"name": n[:160], "ms": us / 1e3, "calls": calls[n]}
                    for n, us in by_name.most_common(25)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the summary and trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bfs_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import (EDGE_FACTOR, NUM_SOURCES, SCALE, SEED,
                            card_line, sample_sources)
    from titan_tpu_torch.models import bfs_hybrid as P
    from titan_tpu_torch.olap import graph500 as G

    card = card_line()
    hg = G.load_or_build(SCALE, EDGE_FACTOR, seed=SEED, verbose=False)
    g = G.graph_from_numpy(hg, "cuda")
    srcs = sample_sources(hg["deg"], NUM_SOURCES)
    P.frontier_bfs_hybrid(g, srcs[0], return_device=True)   # warm-up
    per_source = []
    for src in srcs:
        wall, levels, per = step_times(P, g, src)
        per_source.append({"source": src, "levels": levels, "wall_ms": wall,
                           "steps": per})
        print(f"s{SCALE} source {src}: {levels} levels, {wall:.3f} ms; "
              + ", ".join(f"{k} {v[0]:.3f} ms/{v[1]}x"
                          for k, v in sorted(per.items(),
                                             key=lambda kv: -kv[1][0])))
    prof = device_profile(
        lambda: P.frontier_bfs_hybrid(g, srcs[0], return_device=True),
        args.out and os.path.join(args.out, f"bfs_s{SCALE}_trace.json"),
        ROUND_KERNELS)
    if args.out:
        with open(os.path.join(args.out,
                               f"bfs_s{SCALE}_breakdown.json"), "w") as f:
            json.dump({"scale": SCALE, "card": card,
                       "per_source": per_source, "profile_source": srcs[0],
                       "profile": prof}, f, indent=1)
    print(f"profiled run, source {srcs[0]}, on {card}: wall "
          f"{prof['wall_ms']:.3f} ms under the profiler, device busy "
          f"{prof['device_busy_ms']:.3f} ms (idle share "
          f"{prof['device_idle_share']:.3f}), frontier_round "
          f"{prof['match_ms']:.3f} ms")
    for row in prof["top"]:
        print(f"  {row['ms']:10.3f} ms {row['calls']:6d}x  {row['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
