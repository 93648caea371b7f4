#!/usr/bin/env python3
"""The fused BFS kernel (``csrc/bfs_fused.cu``) at chip_smoke.py phase
6b's four scale-26 sources.

    python3 scripts/torch_fused_replay.py [--iters N] [--out DIR]

Builds or loads chip_smoke.py's Graph500 graph (scale 26; the port's
cache under .bench_cache/torch, which chip_smoke.py fills), uploads it
and takes phase 6's sources (bench.py's rule). From each source it runs
the plain version once (``fused_bfs_reference`` on the card) and checks
the kernel's ``dist`` and ``levels`` against it, then times the kernel:
the mean of ``--iters`` launches by CUDA events after two warm-up
launches, and one launch with the kernel's per-level split where the
checkout's kernel records one (``_trace_split``: each level's mode and
the ms of its top, scan and walk_lists). With ``--out``, the
records are written to DIR as JSON.

It imports the ``titan_tpu_torch`` and ``chip_smoke.py`` of the checkout
it lies in. To time another commit's kernel at the same sources on the
same card, unpack that commit with ``git archive`` under ``_archive/``,
copy this script and chip_smoke.py into it, and run both checkouts'
copies in one run on the card in the order parent, change, change,
parent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def replay(CS, PF, g, src: int, iters: int) -> dict:
    """One source: the kernel against the plain version, its mean ms over
    ``iters`` launches, and its split where the kernel records one."""
    n = g["n"]
    (dp, lp, trace), plain_s = CS.timed(lambda: CS.fused_plain(PF, g, src))
    dk, lk = PF.fused_bfs(g, src)
    CS.check(torch.equal(dk[:n], dp[:n]) and lk == lp, f"the fused kernel "
             f"from {src} differs from its plain version ({lk} levels "
             f"against {lp})")
    ms = CS.cuda_ms(lambda: PF.fused_bfs(g, src), iters, warmup=2)
    g["_trace_split"] = split = []
    try:
        PF.fused_bfs(g, src)
    finally:
        del g["_trace_split"]
    return {"source": src, "levels": lk, "modes": [m for _, m, _ in trace],
            "ms": ms, "plain_ms": plain_s * 1e3,
            "split": split[0] if split else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10,
                    help="timed launches a source")
    ap.add_argument("--out", help="directory for the JSON summary")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_replay: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from titan_tpu_torch.models import bfs_hybrid_fused as PF
    from titan_tpu_torch.olap import graph500 as G

    card = CS.card_line()
    hg = G.load_or_build(CS.SCALE, CS.EDGE_FACTOR, seed=CS.SEED,
                         verbose=False)
    g = G.graph_from_numpy(hg, "cuda")
    recs = [replay(CS, PF, g, src, args.iters)
            for src in CS.sample_sources(hg["deg"], CS.NUM_SOURCES)]
    for r in recs:
        print(f"{ROOT} on {card}: fused BFS from {r['source']}: "
              f"{r['ms']:.4f} ms (mean of {args.iters}), plain "
              f"{r['plain_ms']:.4f} ms, {r['levels']} levels {r['modes']}, "
              f"dist bit-equal to the plain version; split "
              + json.dumps(r["split"]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "fused_replay.json"), "w") as f:
            json.dump({"root": ROOT, "card": card, "sources": recs}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
