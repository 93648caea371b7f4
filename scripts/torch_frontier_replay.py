#!/usr/bin/env python3
"""frontier_round at the BFS main path's widest and heaviest calls, or at
the widest call of the K = 16 BFS cohort.

    python3 scripts/torch_frontier_replay.py [--cohort] [--out DIR]

Builds or loads chip_smoke.py's Graph500 graph (scale 26; the port's
cache under .bench_cache/torch, which chip_smoke.py fills), uploads it
and takes chip_smoke.py's sources. After one warm-up BFS it traces one
BFS a source (``chip_smoke.trace_sources``: CUDA events around every
``frontier_round`` call) and replays the widest call and the call whose
bound bytes are largest, as phase 6 of chip_smoke.py does: bit-equality
with the plain version, the kernel's time and the plain version's, and
the bound under both dstT layouts. With ``--out``, the two replays are
written to DIR as JSON.

With ``--cohort`` it runs chip_smoke.py phase 7's K = 16 cohort instead
(16 sources by bench.py's rule; one warm-up, then one run traced by
``chip_smoke.BatchedTrace``), prints its wall time and per-level split
(plan, rounds, exhaust), replays the widest call cut to its first
4, 8 and 16 jobs (``chip_smoke.k_sweep``): the time a job, and the
frontier sectors and bound under the job-major and the word layout, and
prints each ``batched_exhaust`` call's device ms and replays the largest
(``chip_smoke.exhaust_replay``: bit-equal to the plain version, its
time against ``exhaust_bytes``' bound, and the frontier summary's where
the checkout has one).

It imports the ``titan_tpu_torch`` and ``chip_smoke.py`` of the
checkout it lies in. To time another commit's kernel at the same calls
in one chip call, unpack that commit with ``git archive`` under
``_archive/``, copy this script and chip_smoke.py into it, and run both
checkouts' copies in the order parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cohort(CS, P, F, g, hg, card, out) -> int:
    srcs = CS.sample_sources(hg["deg"], CS.BATCH_K)

    def run():
        return P.frontier_bfs_batched(g, srcs, return_device=True)
    run()                                                   # warm-up
    with CS.BatchedTrace(P) as tr:
        _, seconds = CS.wall_s(run)
    split = tr.split()
    print(f"{ROOT} on {card}: K={CS.BATCH_K} cohort traced in "
          f"{seconds:.4f} s, frontier_round {len(tr.calls)} calls "
          f"{tr.kernel_ms():.4f} ms summed, largest exhaust p_cap "
          f"{tr.p_cap}; per level (device ms): {json.dumps(split)}",
          flush=True)
    sweep = CS.k_sweep(F, {**tr.widest, "source": "cohort"}, card)
    sweeps = tr.sweep_ms()
    x = CS.exhaust_replay(F, tr.largest)
    print(f"{ROOT} on {card}: batched_exhaust calls of the traced run "
          f"(device ms, wrapper included) {json.dumps(sweeps)}; the largest "
          f"(call {tr.largest['index']}, {x['live']} live pairs, "
          f"{x['found']} candidate bits) replayed: {x['ms']:.4f} ms, "
          f"bit-equal to the plain version ({x['plain_ms']:.4f} ms), bound "
          f"{x['bound_ms']:.4f} ms; summary "
          + json.dumps(x.get("summary")), flush=True)
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "cohort_sweep.json"), "w") as f:
            json.dump({"root": ROOT, "card": card, "seconds": seconds,
                       "split": split, "p_cap": tr.p_cap,
                       "kernel_ms": tr.kernel_ms(), "sweep": sweep,
                       "exhaust_ms": sweeps, "exhaust": x}, f, indent=1)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the JSON summary")
    ap.add_argument("--cohort", action="store_true",
                    help="the K = 16 cohort's widest call, cut to 4, 8, 16 "
                         "jobs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_frontier_replay: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from titan_tpu_torch.models import bfs_hybrid as P
    from titan_tpu_torch.olap import graph500 as G
    from titan_tpu_torch.ops import frontier as F

    card = CS.card_line()
    hg = G.load_or_build(CS.SCALE, CS.EDGE_FACTOR, seed=CS.SEED,
                         verbose=False)
    g = G.graph_from_numpy(hg, "cuda")
    if args.cohort:
        return cohort(CS, P, F, g, hg, card, args.out)
    srcs = CS.sample_sources(hg["deg"], CS.NUM_SOURCES)
    P.frontier_bfs_hybrid(g, srcs[0], return_device=True)   # warm-up
    widest, heaviest, per_call = CS.trace_sources(P, g, srcs)
    recs = {"widest": CS.replay(F, widest)}
    recs["heaviest"] = (recs["widest"] if heaviest is widest
                        else CS.replay(F, heaviest))
    print(f"{ROOT} on {card}: frontier_round calls a source {per_call}")
    for name, r in recs.items():
        CS.say_replay(name, r)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "frontier_replay.json"), "w") as f:
            json.dump({"root": ROOT, "card": card, "calls": per_call,
                       "replays": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
