#!/usr/bin/env python3
"""Where the serving layer spends a fused K = 16 BFS batch on the card,
on chip_smoke.py's scale-22 graph.

    python3 scripts/torch_serving_breakdown.py [--out DIR]

Builds or loads chip_smoke.py's Graph500 scale-22 graph (the port's cache
under .bench_cache/torch), makes its snapshot and caches its chunked CSR,
then, after one warm-up of each, runs three forms of the same K = 16
batch (chip_smoke.py's sources) ``REPS`` times each, in turns:

* ``direct``: ``frontier_bfs_batched(snap, sources)`` on the main thread;
* ``thread``: the same call in a ``threading.Thread``;
* ``served``: 16 BFS jobs submitted to a paused ``JobScheduler``
  (profiling off, tracing on), started, waited for; the first job's
  split from its trace (queue, the model call's ``run`` span, the rest).

Host seconds around each, the card synchronised. Then the host parts
the batcher adds (the ``reached`` counts of the 16 rows, the ledger's
``snapshot_csr_bytes``), and one direct and one served batch under
``torch.profiler``: wall, device busy time and idle share.

With ``--out``, the summary (JSON) and the Chrome traces are written to
DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5


def wall(fn) -> tuple:
    """(fn(), host seconds around it, the card synchronised)."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def in_thread(fn):
    """fn() on a new thread, joined; re-raises its exception."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:      # re-raised on the caller's thread
            box["err"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the summary and traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from chip_smoke import (BATCH_K, EDGE_FACTOR, ENGINE_SCALE, SEED,
                            card_line, sample_sources, split)
    from torch_bfs_breakdown import device_profile
    from titan_tpu_torch.models import bfs_hybrid as P
    from titan_tpu_torch.olap import graph500 as G
    from titan_tpu_torch.olap import snapshot as SN
    from titan_tpu_torch.olap.api import JobSpec
    from titan_tpu_torch.olap.serving import JobScheduler
    from titan_tpu_torch.olap.serving.hbm import snapshot_csr_bytes
    from titan_tpu_torch.utils.metrics import MetricManager

    card = card_line()
    print(card, flush=True)
    hg = G.load_or_build(ENGINE_SCALE, EDGE_FACTOR, seed=SEED, verbose=False)
    snap = SN.from_chunked_csr(hg)
    P.build_chunked_csr(snap)
    srcs = sample_sources(hg["deg"], BATCH_K)
    specs = [JobSpec(kind="bfs", params={"source_dense": s}) for s in srcs]

    def direct():
        return P.frontier_bfs_batched(snap, srcs)[0]

    def served(splits=None):
        sched = JobScheduler(snapshot=snap, autostart=False,
                             max_batch=BATCH_K, profiling=False,
                             metrics=MetricManager())
        try:
            jobs = [sched.submit(s) for s in specs]
            sched.start()
            for j in jobs:
                if not j.wait(300) or j.state.value != "done":
                    raise RuntimeError(f"{j}: {j.error}")
            if splits is not None:
                splits.append(split(sched, jobs[0]))
            return np.stack([j.result["dist"] for j in jobs])
        finally:
            sched.close()

    ref = direct()
    forms = {"direct": direct, "thread": lambda: in_thread(direct),
             "served": served}
    for name, fn in forms.items():                  # warm-up of each
        if not np.array_equal(fn(), ref):
            raise RuntimeError(f"{name} differs from the direct run")
    times = {k: [] for k in forms}
    splits: list = []
    for rep in range(REPS):
        order = list(forms) if rep % 2 == 0 else list(forms)[::-1]
        for name in order:
            fn = (lambda: served(splits)) if name == "served" else forms[name]
            times[name].append(wall(fn)[1])
    rows = [r for r in ref]
    _, reached_s = wall(lambda: [int((r < (1 << 30)).sum()) for r in rows])
    _, bytes_s = wall(lambda: snapshot_csr_bytes(snap))
    out = {"card": card, "K": BATCH_K, "reps": REPS,
           "seconds": times,
           "median_s": {k: statistics.median(v) for k, v in times.items()},
           "served_first_job_split": splits,
           "reached_counts_s": reached_s, "snapshot_csr_bytes_s": bytes_s}
    for name, fn in (("direct", direct), ("served", served)):
        trace = os.path.join(args.out, f"serving_{name}.json") \
            if args.out else None
        out[f"profile_{name}"] = device_profile(fn, trace)
    print(json.dumps(out, indent=1), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "serving_breakdown.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
