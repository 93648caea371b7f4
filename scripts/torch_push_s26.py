#!/usr/bin/env python3
"""The push-frontier BFS at chip_smoke.py's scale 26 on the card.

    python3 scripts/torch_push_s26.py [--out DIR]

Loads chip_smoke.py's Graph500 graph (scale 26, the port's cache under
.bench_cache/torch, which chip_smoke.py fills) and measures the host
cost of the push BFS's out-CSR: ``olap/snapshot.from_chunked_csr``, then
``out_csr()`` (the native counting sort over 2^31 edges), with the
host's available memory before and the resident set after. When that
cost is within ``HOST_BUDGET_S`` and the host had ``FREE_BYTES`` free,
it runs ``models/bfs.frontier_bfs_tiled``
with its defaults from bench.py's first source (the plain
``frontier_bfs`` refuses 2^31 edges) and holds its ``dist`` to
``frontier_bfs_hybrid``'s from the same source. With ``--out``, the
summary (JSON) is written to DIR.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the tiled run goes ahead only when building the out-CSR on the host
#: (from_chunked_csr, then out_csr) took at most this many seconds
HOST_BUDGET_S = 120.0
#: ... and the host had this much memory free before the build (the
#: snapshot's src and dst, the out-CSR and its permutation: about 43 GB
#: at 2^31 edges)
FREE_BYTES = 60 << 30


def mem_available() -> int:
    """The host's available memory, from /proc/meminfo."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the summary")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_push_s26: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import (EDGE_FACTOR, SCALE, SEED, card_line,
                            drop_push_caches, push_runs, rss_bytes,
                            sample_sources, wall_s)
    from titan_tpu_torch.models import bfs as PB
    from titan_tpu_torch.models import bfs_hybrid as P
    from titan_tpu_torch.olap import graph500 as G
    from titan_tpu_torch.olap import snapshot as SN

    card = card_line()
    print(card, flush=True)
    hg = G.load_or_build(SCALE, EDGE_FACTOR, seed=SEED, verbose=False)
    rec = {"card": card, "scale": SCALE, "budget_s": HOST_BUDGET_S,
           "mem_available_bytes": mem_available()}
    rec["ran"] = rec["mem_available_bytes"] >= FREE_BYTES
    if rec["ran"]:
        snap, rec["from_chunked_csr_s"] = wall_s(
            lambda: SN.from_chunked_csr(hg))
        _, rec["out_csr_s"] = wall_s(snap.out_csr)
        rec["host_s"] = rec["from_chunked_csr_s"] + rec["out_csr_s"]
        rec["rss_bytes"] = rss_bytes()
        rec["ran"] = rec["host_s"] <= HOST_BUDGET_S
    if rec["ran"]:
        src = sample_sources(hg["deg"], 1)[0]
        g = G.graph_from_numpy(hg, "cuda")
        want, rec["hybrid_levels"] = P.frontier_bfs_hybrid(g, src)
        del g
        torch.cuda.empty_cache()
        rec["runs"] = push_runs(PB, snap, src, want, None, "s26")
        drop_push_caches(snap)
    print(f"torch_push_s26: s{SCALE} push BFS on {card}: "
          + ("ran, each dist equal to frontier_bfs_hybrid's"
             if rec["ran"] else "tiled run left out (host memory or the "
             "out-CSR's host cost past its budget)") + ": "
          + json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_push_s26.json"), "w") as f:
            json.dump(rec, f, indent=1)
    gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
