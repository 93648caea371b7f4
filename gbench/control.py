"""The control of a cell's check: the reference put in the system's place
and computed one step below what the configuration states, judged by
the cell's own comparison at the cell's own size. It has to come out not
correct; its smallest reading over the seeds is the upper reading the
limits are set below.

    python3 -m gbench.control --workload <cell> --seeds 11,12,13

BFS cells: the tuples followed as directed edges, which breaks the
configuration's "undirected" (BFS states no precision). PageRank cells:
the reference in bfloat16 for the configuration's float32. The system
under test is not run. One JSON line a seed: the compared numbers, each
with its limit, and whether the limits pass (they must not).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from gbench import registry
from gbench.graph import Graph


def control_numbers(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The cell's compared numbers with the control's answers in the
    served answers' place, for ``mix["sample"]`` jobs."""
    kind = registry.job_kind(mix["job"])
    graph = Graph(cfg, seed, device)
    u, v = graph.edges()
    inp = kind.inputs(graph, u, v, mix)
    del u, v
    keys = inp.get("keys") or [None]
    samples = [({"summary": {"source": keys[i % len(keys)]}}, None)
               for i in range(int(mix["sample"]))]
    numbers, _ = kind.verify(graph, inp, [], samples, answer=kind.control)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    mix = registry.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        numbers = control_numbers(cfg, mix, seed, args.device)
        limits = mix["limits"]
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "numbers": {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()},
            "passes": all(v <= limits[k] for k, v in numbers.items()),
            "seconds": time.time() - t0,
            "device": torch.cuda.get_device_name(0)
            if str(args.device).startswith("cuda") else "cpu"}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
