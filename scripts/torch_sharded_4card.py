#!/usr/bin/env python3
"""The sharded hybrid BFS over every card of one host, over NCCL, at
chip_smoke.py's scale 26.

    python3 scripts/torch_sharded_4card.py [--scale 26] [--out DIR]

Spawns one rank a card (``parallel/multihost.launch``, world size
``torch.cuda.device_count()``, rank r on ``cuda:r``). Rank 0 builds or
loads chip_smoke.py's Graph500 graph (the port's cache under
.bench_cache/torch), the other ranks wait for it and memory-map it, and
each rank packs and uploads only its own block. Then
``frontier_bfs_hybrid_sharded`` runs from bench.py's 4 sources: one
untimed call, then the best of 3 a source; rank 0 holds each ``dist``
and ``levels`` bit-equal to a single-card ``frontier_bfs_hybrid`` on its
card. It prints the card's name and power limit, the TEPS (Graph500's
count, harmonic mean over the sources), each source's wall and the
exchanged ids a level (``LAST_PROFILE``), and with ``--out`` writes the
summary (JSON) to DIR. Exits 1 without a card and 2 on a difference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(mesh, scale: int) -> dict:
    """One rank: the graph, its block, the timed runs; rank 0 checks and
    returns the summary."""
    sys.path.insert(0, ROOT)
    from chip_smoke import EDGE_FACTOR, NUM_SOURCES, REPS, SEED, \
        sample_sources
    from titan_tpu_torch.device import INF
    from titan_tpu_torch.models import bfs_hybrid as P
    from titan_tpu_torch.models import bfs_hybrid_sharded as SH
    from titan_tpu_torch.olap import graph500 as G

    def sync():
        torch.cuda.synchronize(mesh.device)
        mesh.all_reduce(torch.zeros(1, device=mesh.device), "sum")

    t0 = time.time()
    if mesh.rank == 0:
        hg = G.load_or_build(scale, EDGE_FACTOR, seed=SEED, verbose=False)
    sync()                                    # rank 0's cache is written
    if mesh.rank != 0:
        hg = G.load_or_build(scale, EDGE_FACTOR, seed=SEED, verbose=False)
    build_s = time.time() - t0
    srcs = sample_sources(hg["deg"], NUM_SOURCES)
    t0 = time.time()
    SH.frontier_bfs_hybrid_sharded(hg, srcs[0], mesh, return_device=True)
    sync()
    first_s = time.time() - t0
    rows = []
    for src in srcs:
        best = None
        for _ in range(REPS):
            sync()
            t = time.time()
            dist, levels = SH.frontier_bfs_hybrid_sharded(
                hg, src, mesh, return_device=True)
            sync()
            t = time.time() - t
            if best is None or t < best[2]:
                best = (dist, levels, t, list(SH.LAST_PROFILE))
        rows.append((src,) + best)
    if mesh.rank != 0:
        return {}
    deg_orig = np.asarray(hg["deg_orig"])
    hg.pop(SH._CACHE, None)
    torch.cuda.empty_cache()
    g = G.graph_from_numpy(hg, mesh.device)
    out = []
    for src, dist, levels, t, prof in rows:
        ref, ref_levels = P.frontier_bfs_hybrid(g, src, return_device=True,
                                                device=mesh.device)
        equal = bool(torch.equal(dist, ref)) and levels == ref_levels
        m2, reach = G.reachable_edge_sum(dist, deg_orig, INF)
        out.append({"source": src, "levels": levels, "t_bfs": t,
                    "teps": (m2 // 2) / t, "reach": reach,
                    "bit_equal_vs_single_card": equal,
                    "exchanged_ids": [p["exchanged_ids"] for p in prof],
                    "found_max_per_chip": [p["found_max_per_chip"]
                                           for p in prof],
                    "modes": [p["mode"] for p in prof],
                    "retries": [p["retries"] for p in prof]})
    teps = len(out) / sum(1.0 / r["teps"] for r in out)
    return {"world": mesh.world, "scale": scale, "build_s": build_s,
            "first_call_s": first_s, "teps": teps, "sources": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--out", help="directory for the summary")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sharded_4card: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line
    from titan_tpu_torch.parallel.multihost import launch

    print(card_line(), flush=True)
    world = torch.cuda.device_count()
    t0 = time.time()
    rec = launch(rank_main, world, "cuda", "nccl", (args.scale,),
                 timeout=3000)
    rec["wall_s"] = time.time() - t0
    print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_sharded_4card.json"),
                  "w") as f:
            json.dump(rec, f, indent=1)
    ok = all(r["bit_equal_vs_single_card"] for r in rec["sources"])
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
