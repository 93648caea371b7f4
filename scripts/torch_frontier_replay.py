#!/usr/bin/env python3
"""frontier_round at the BFS main path's widest and heaviest calls.

    python3 scripts/torch_frontier_replay.py [--out DIR]

Builds or loads chip_smoke.py's Graph500 graph (scale 26; the port's
cache under .bench_cache/torch, which chip_smoke.py fills), uploads it
and takes chip_smoke.py's sources. After one warm-up BFS it traces one
BFS a source (``chip_smoke.trace_sources``: CUDA events around every
``frontier_round`` call) and replays the widest call and the call whose
bound bytes are largest, as phase 6 of chip_smoke.py does: bit-equality
with the plain version, the kernel's time and the plain version's, and
the bound under both dstT layouts. With ``--out``, the two replays are
written to DIR as JSON.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the JSON summary")
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
