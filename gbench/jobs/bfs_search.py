"""Graph500 search jobs: one ``bfs`` job a search key, through the
scheduler's BFS fusion.

Inputs (the benchmark's, from the seed): the configuration's search keys,
vertices of degree > 0 drawn from the seed. Client ``c`` walks every key
in an order of its own, drawn from the seed, over and over.

Kept from every job: its source, ``levels`` and ``reached``. Kept from a
sample of them (the harness draws it from the seed): the ``dist`` row.

The check, once the system under test is gone: a plain BFS over the
benchmark's own edge list from each sampled job's source must give the
served row vertex for vertex and its level count; the vertices every
served job reached must be its source's component. The TEPS numerator of
a job is Graph500's: the input tuples in its source's component.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from gbench import graphgen
from gbench.reference import bfs as RB

#: the end-to-end work a job of this kind counts under
WORK = "edges"


def inputs(graph, u, v, mix: dict) -> dict:
    deg = graphgen.degrees(u, v, graph.n)
    keys = graphgen.search_keys(deg, int(graph.cfg["search_keys"]),
                                graph.seed)
    return {"keys": keys}


def make_specs(inp: dict, mix: dict, seed: int):
    from titan_tpu_torch.olap.api import JobSpec

    keys = inp["keys"]

    def specs(client: int):
        rng = random.Random(f"{seed}/{client}")
        while True:
            order = list(keys)
            rng.shuffle(order)
            for k in order:
                yield JobSpec(kind="bfs", params={"source_dense": int(k)})
    return specs


def summary(job) -> dict:
    r = job.result or {}
    return {"source": int(job.spec.params["source_dense"]),
            "levels": r.get("levels"), "reached": r.get("reached")}


def payload(job):
    """A copy of the served row: the row is a view of the batch's
    ``[K, n]`` array, which it would keep alive."""
    return np.array(job.result["dist"], copy=True)


def control(u, w, n: int, source: int):
    """The control's answer for one search: BFS over the tuples as
    directed edges, against the configuration's undirected graph."""
    return RB.bfs(u, w, n, source, directed=True)


def verify(graph, inp: dict, records: list, samples: list,
           answer=None) -> tuple:
    """``(numbers, work)``: each compared number by name (the mix gives
    its limit), and each record's TEPS numerator (None for a job that
    did not finish).
    ``answer(u, w, n, source) -> (dist, levels)`` stands in for the
    served rows where given (the control)."""
    u, w = graph.edges()
    n = graph.n
    comps: list = []          # (reached mask, its size, its tuples)

    def component(source: int):
        for mask, size, tuples in comps:
            if bool(mask[source]):
                return size, tuples
        dist, _ = RB.bfs(u, w, n, source)
        mask = dist >= 0
        comps.append((mask, int(mask.sum()),
                      RB.component_tuples(u, w, mask)))
        return comps[-1][1], comps[-1][2]

    row_diff = 0
    levels_diff = 0
    for rec, row in samples:
        src = rec["summary"]["source"]
        ref, ref_levels = RB.bfs(u, w, n, src)
        if answer is not None:
            got, got_levels = answer(u, w, n, src)
        else:
            got = torch.from_numpy(row).to(graph.device)
            got_levels = rec["summary"]["levels"]
        # a served distance outside [0, n) marks a vertex no level reached
        got = torch.where((got >= 0) & (got < n), got,
                          torch.full_like(got, RB.UNREACHED))
        row_diff += int((got != ref).sum())
        levels_diff += int(got_levels != ref_levels)
    reached_diff = 0
    work = []
    for rec in records:
        if not rec["ok"]:
            work.append(None)
            continue
        size, tuples = component(rec["summary"]["source"])
        reached_diff += int(rec["summary"]["reached"] != size)
        work.append(tuples)
    return {"bfs_dist_mismatch": row_diff,
            "bfs_levels_mismatch": levels_diff,
            "bfs_reached_mismatch": reached_diff}, work
