#!/usr/bin/env python3
"""The serving plane's ``mesh=`` over every card of one host, at
chip_smoke.py's scale 26.

    python3 scripts/torch_serving_mesh_4card.py [--scale 26]
        [--devices cuda:0,cuda:1,...] [--out DIR]

One process drives the cards (``parallel.mesh.local_mesh``, every visible
card unless ``--devices`` names them; a name may repeat). It builds or
loads chip_smoke.py's Graph500 graph (the port's cache under
.bench_cache/torch), makes its snapshot (``olap/snapshot.from_chunked_csr``)
and serves phase 7's K = 16 BFS cohort (bench.py's source rule) through
``JobScheduler(mesh=)`` twice: the batcher places the snapshot's chunked
CSR as one vertex block a card (``parallel/partition.place_batched_csr``,
the first run) and ``frontier_bfs_batched`` runs the blocks in lockstep,
each level's frontier words copied between the cards. Then
``frontier_bfs_batched`` on ``cuda:0`` alone is the reference: every
served row must be bit-equal to it and pass Graph500's validation.

It prints the card's name and power limit, the served walls (first submit
to last result), the wall of the same cohort called directly on the placed
graph (its dist left on the first card) and on one card, each card's placed
block and peak memory against
``hbm.meshed_snapshot_csr_bytes``, each level's ms (the batcher's
``round`` spans: the host clock between level callbacks), the frontier
words copied a level and the kernels' launches, and with ``--out`` writes
the summary (JSON) to DIR. Exits 1 without a card and 2 on a difference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def level_ms(sched, job) -> list:
    """The job's ``round`` spans: ``[level, ms]`` from one level callback
    to the next."""
    out = []

    def walk(node):
        if node["name"] == "round":
            out.append([node["attrs"]["level"], node.get("duration_ms")])
        for c in node["children"]:
            walk(c)
    for root in sched.tracer.tree(job.id)["spans"]:
        walk(root)
    return sorted(out)


def run(scale: int, devices) -> dict:
    sys.path.insert(0, ROOT)
    from chip_smoke import (BATCH_K, EDGE_FACTOR, SEED, check,
                            sample_sources, serve, validate)
    from titan_tpu_torch.device import INF
    from titan_tpu_torch.models import bfs_hybrid as P
    from titan_tpu_torch.olap import graph500 as G
    from titan_tpu_torch.olap import snapshot as SN
    from titan_tpu_torch.olap.api import JobSpec
    from titan_tpu_torch.olap.serving import JobScheduler
    from titan_tpu_torch.olap.serving.hbm import meshed_snapshot_csr_bytes
    from titan_tpu_torch.ops import frontier as F
    from titan_tpu_torch.parallel import partition as PP
    from titan_tpu_torch.parallel.mesh import local_mesh
    from titan_tpu_torch.utils.metrics import MetricManager

    mesh = local_mesh(devices)
    cards = sorted(set(mesh.devices), key=str)
    F.kernel_library()
    F.exhaust_library()
    t0 = time.time()
    hg = G.load_or_build(scale, EDGE_FACTOR, seed=SEED, verbose=False)
    build_s = time.time() - t0
    t0 = time.time()
    snap = SN.from_chunked_csr(hg)
    snap_s = time.time() - t0
    srcs = sample_sources(hg["deg"], BATCH_K)
    specs = [JobSpec(kind="bfs", params={"source_dense": s}) for s in srcs]
    per_dev = meshed_snapshot_csr_bytes(snap, mesh.size)
    for d in cards:
        torch.empty(0, device=d)          # the card's allocator exists
        torch.cuda.reset_peak_memory_stats(d)
    base = {str(d): torch.cuda.memory_allocated(d) for d in cards}
    sched = JobScheduler(snapshot=snap, mesh=mesh, device=mesh.devices[0],
                         autostart=False, max_batch=BATCH_K,
                         metrics=MetricManager())
    walls, launches = [], []
    try:
        for _ in range(2):
            F.frontier_round.launches = 0
            F.batched_exhaust.launches = F._launch_summary.launches = 0
            jobs, wall = serve(sched, specs, wait_s=3000.0)
            walls.append(wall)
            launches.append({"frontier_round": F.frontier_round.launches,
                             "batched_exhaust": F.batched_exhaust.launches,
                             "exhaust_summary": F._launch_summary.launches})
            check(all(j.state.value == "done" and j.batch_k == BATCH_K
                      for j in jobs), "served meshed jobs: " + ", ".join(
                f"{j.state.value} {j.batch_k} {j.error}" for j in jobs))
        resident = sched.ledger.resident_bytes()
        levels = level_ms(sched, jobs[0])
        copied = {k: list(v) for k, v in P.LAST_WORDS_COPIED.items()}
    finally:
        sched.close()
    peak = {str(d): torch.cuda.max_memory_allocated(d) for d in cards}
    placed = PP.place_batched_csr(snap, mesh)

    def synced(fn):
        for d in cards:
            torch.cuda.synchronize(d)
        t = time.time()
        out = fn()
        for d in cards:
            torch.cuda.synchronize(d)
        return out, time.time() - t
    # the same cohort called directly on the placed graph, its dist left
    # gathered on the first card (no host readback)
    _, direct_s = synced(lambda: P.frontier_bfs_batched(
        placed, srcs, return_device=True, device=mesh.devices[0]))
    blocks = [{"device": str(sh["device"]), "lo": sh["lo"], "hi": sh["hi"],
               "columns": sh["q_total"],
               "bytes": sum(sh[k].numel() * sh[k].element_size()
                            for k in ("dstT", "colstart", "degc"))}
              for sh in placed["_shards"]]
    rows = [j.result["dist"] for j in jobs]
    levels_k = [j.result["levels"] for j in jobs]
    del placed, jobs, sched
    delattr(snap, PP.MESH_CACHE)
    torch.cuda.empty_cache()

    # the reference: one card
    dev0 = torch.device("cuda", 0)
    g = G.graph_from_numpy(hg, dev0)
    ref, ref_levels, _ = P.frontier_bfs_batched(g, srcs, return_device=True,
                                                device=dev0)
    _, one_card_s = synced(lambda: P.frontier_bfs_batched(
        g, srcs, return_device=True, device=dev0))
    equal = []
    for k, src in enumerate(srcs):
        row = torch.from_numpy(rows[k]).to(dev0)
        same = bool(torch.equal(row, ref[k])) \
            and levels_k[k] == int(ref_levels[k])
        equal.append(same)
        if same:
            validate(g, row, src, INF)
    return {"scale": scale, "devices": [str(d) for d in mesh.devices],
            "k": BATCH_K, "sources": srcs, "build_s": build_s,
            "snapshot_s": snap_s, "served_walls_s": walls,
            "meshed_direct_s": direct_s, "one_card_direct_s": one_card_s, "launches": launches,
            "meshed_snapshot_csr_bytes": per_dev, "ledger_resident": resident,
            "blocks": blocks, "allocated_before": base, "peak_bytes": peak,
            "level_ms_job0": levels, "words_copied": copied,
            "levels": levels_k, "bit_equal_vs_one_card": equal}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--devices", help="comma-separated devices (default: "
                    "every visible card)")
    ap.add_argument("--out", help="directory for the summary")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_mesh_4card: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line

    print(card_line(), flush=True)
    t0 = time.time()
    rec = run(args.scale, args.devices.split(",") if args.devices else None)
    rec["wall_s"] = time.time() - t0
    print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_serving_mesh_4card.json"),
                  "w") as f:
            json.dump(rec, f, indent=1)
    return 0 if all(rec["bit_equal_vs_one_card"]) else 2


if __name__ == "__main__":
    sys.exit(main())
