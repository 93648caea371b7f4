#!/usr/bin/env python3
"""Where the port's frontier SSSP and WCC spend bench.py's sssp_wcc stage
on the card.

    python3 scripts/torch_frontier_breakdown.py [--scale 26] [--out DIR]

Loads chip_smoke.py's Graph500 graph of that scale (the port's cache
under .bench_cache/torch, built when missing) and uploads it. From
bench.py's SSSP source (the first vertex of degree > 0), after one
warm-up run of each, it measures:

* one ``frontier_sssp`` with ``_trace_rounds`` and ``_trace_plan_drain``
  set, as bench.py runs it: each round's listed members and chunks and
  its plan and push seconds (``chip_smoke.sssp_round_split``);
* ``frontier_sssp`` and ``frontier_wcc`` once each under
  ``torch.profiler``: wall, the device's busy and idle shares, device
  time by kernel name;
* the two mass histograms of one quantile plan (round 2's), timed both
  ways on the same inputs (CUDA events, mean of 10): the port's
  ``bincount`` over the changed vertices and the JAX package's form, a
  scatter-add of every vertex (the unchanged with mass 0 into the last
  bin);
* the untraced SSSP with the dropped lanes of each push spread over
  ``frontier.SPARE`` slots (the port's) and all sent to one slot
  (``SPARE = 1``), in turns: spread, one, one, spread (host wall).

With ``--out``, the summary (JSON) and the two Chrome traces are written
to DIR.
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


def plan_histograms(FR, g, src: int, at_round: int = 2) -> list[dict]:
    """The mass histograms of the plan of round ``at_round``, each timed
    as the port computes it and in the JAX package's scatter-add form;
    the two must agree."""
    from chip_smoke import check, cuda_ms
    real, seen = FR._mass_hist, []

    def spy(b, mass, sel, bins):
        if state["round"] == at_round:
            seen.append((b.clone(), mass, sel.clone(), bins))
        return real(b, mass, sel, bins)

    state = {"round": -1}

    def count(rounds):
        state["round"] = rounds
        return True
    FR._mass_hist = spy
    try:
        FR.frontier_sssp(g, src, on_round=count, return_device=True)
    finally:
        FR._mass_hist = real
    rows = []
    for b, mass, sel, bins in seen:
        def jax_form():
            idx = torch.where(sel, b, bins - 1).long()
            return torch.zeros(bins, dtype=torch.int32,
                               device=b.device).index_add_(
                0, idx, torch.where(sel, mass, 0))
        check(torch.equal(real(b, mass, sel, bins), jax_form()),
              "the two histogram forms disagree")
        rows.append({"selected": int(sel.sum()), "n": int(sel.numel()),
                     "bincount_ms": cuda_ms(lambda: real(b, mass, sel, bins),
                                            10),
                     "scatter_add_ms": cuda_ms(jax_form, 10)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--out", help="directory for the summary and traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_frontier_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from chip_smoke import EDGE_FACTOR, SEED, card_line, sssp_round_split
    from torch_bfs_breakdown import device_profile
    from titan_tpu_torch.models import frontier as FR
    from titan_tpu_torch.olap import graph500 as G

    card = card_line()
    hg = G.load_or_build(args.scale, EDGE_FACTOR, seed=SEED, verbose=False)
    g = G.graph_from_numpy(hg, "cuda")
    src = int(np.flatnonzero(np.asarray(hg["deg"]) > 0)[0])

    def sssp():
        return FR.frontier_sssp(g, src, return_device=True)

    def wcc():
        return FR.frontier_wcc(g, return_device=True)
    sssp()                                                   # warm-up
    wcc()
    trace = []
    g["_trace_rounds"], g["_trace_plan_drain"] = trace, True
    torch.cuda.synchronize()
    t0 = time.time()
    _, rounds = sssp()
    torch.cuda.synchronize()
    wall = time.time() - t0
    del g["_trace_rounds"], g["_trace_plan_drain"]
    split = sssp_round_split(trace)
    plan_s = sum(r["plan_s"] for r in split)
    push_s = sum(r["push_s"] for r in split)
    print(f"s{args.scale} frontier_sssp from {src} on {card}: {rounds} "
          f"rounds, {wall:.4f} s traced and drained; plans {plan_s:.4f} s, "
          f"pushes {push_s:.4f} s; per round (nf, m8, plan_s, push_s): "
          + json.dumps(split))
    hists = plan_histograms(FR, g, src)
    for h in hists:
        print(f"round-2 plan histogram over {h['selected']} of {h['n']} "
              f"vertices: bincount of the changed {h['bincount_ms']:.4f} ms, "
              f"scatter-add of every vertex {h['scatter_add_ms']:.4f} ms")
    spare = FR.SPARE
    walls = {spare: [], 1: []}
    for k in (spare, 1, 1, spare):
        FR.SPARE = k
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            sssp()
            torch.cuda.synchronize()
            walls[k].append(time.time() - t0)
        finally:
            FR.SPARE = spare
    print(f"untraced frontier_sssp, dropped lanes over {spare} spare slots: "
          f"{walls[spare]} s; over one: {walls[1]} s")
    summary = {"scale": args.scale, "card": card, "source": src,
               "rounds": rounds, "traced_s": wall, "rounds_split": split,
               "histograms": hists,
               "spare_walls_s": {str(k): v for k, v in walls.items()}}
    for name, fn in (("sssp", sssp), ("wcc", wcc)):
        prof = device_profile(fn, args.out and os.path.join(
            args.out, f"frontier_{name}_s{args.scale}_trace.json"))
        summary[name] = prof
        print(f"profiled {name} on {card}: wall {prof['wall_ms']:.3f} ms "
              f"under the profiler, device busy "
              f"{prof['device_busy_ms']:.3f} ms (idle share "
              f"{prof['device_idle_share']:.3f})")
        for row in prof["top"][:15]:
            print(f"  {row['ms']:10.3f} ms {row['calls']:6d}x  {row['name']}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"frontier_s{args.scale}_"
                               "breakdown.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
