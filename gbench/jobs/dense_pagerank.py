"""PageRank as a vertex program: one ``dense`` job a request, the
engine's supersteps through the scheduler (no fusion: ``dense`` jobs run
alone).

Inputs (the benchmark's): the program's parameters from the mix
(``alpha``, ``iterations``, no early stop), ``n`` and each vertex's
inverse out-degree in the configuration's simple graph, worked out from
the benchmark's own edge list.

Kept from every job: its ``iterations``. Kept from a sample of them: the
ranks. The check, once the system under test is gone: the plain float64
PageRank over the benchmark's own simple graph; each sampled job's
widest relative gap from it, and every job's iteration count. A job's
EVPS numerator is LDBC Graphalytics' |V| + |E| of the dataset: vertices
with an edge, and undirected edges after dedup and self-loop removal.
"""

from __future__ import annotations

import numpy as np
import torch

from gbench.graph import simple_edges
from gbench.reference import pagerank as RP

#: the end-to-end work a job of this kind counts under
WORK = "ev"


def inputs(graph, u, v, mix: dict) -> dict:
    src, dst = simple_edges(u, v, graph.n)
    outdeg = torch.zeros(graph.n, dtype=torch.int64, device=src.device)
    outdeg.index_add_(0, src, torch.ones_like(src))
    inv = torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1).to(
        torch.float64), 0.0).to(torch.float32)
    return {"inv_outdeg": inv.cpu().numpy(),
            "vertices": int((outdeg > 0).sum()),
            "edges": int(src.shape[0]) // 2,
            "directed_edges": int(src.shape[0]),
            "alpha": float(mix["alpha"]),
            "iterations": int(mix["iterations"])}


def make_specs(inp: dict, mix: dict, seed: int):
    from titan_tpu_torch.models.pagerank import PageRank
    from titan_tpu_torch.olap.api import JobSpec

    n = int(inp["inv_outdeg"].shape[0])

    def specs(client: int):
        while True:
            yield JobSpec(kind="dense", params={
                "program": PageRank(inp["alpha"], inp["iterations"], 0.0),
                "n": n, "inv_outdeg": inp["inv_outdeg"]})
    return specs


def summary(job) -> dict:
    r = job.result or {}
    return {"iterations": r.get("iterations")}


def payload(job):
    return np.array(job.result["rank"], copy=True)


def control(src, dst, n: int, alpha: float, iterations: int):
    """The control's ranks: the reference in bfloat16, its sums in
    float32."""
    return RP.pagerank(src, dst, n, alpha, iterations,
                       dtype=torch.bfloat16, acc_dtype=torch.float32)


def verify(graph, inp: dict, records: list, samples: list,
           answer=None) -> tuple:
    """``(numbers, work)`` as ``bfs_search.verify`` gives them;
    ``answer(src, dst, n, alpha, iterations)`` stands in for the served
    ranks where given (the control)."""
    u, v = graph.edges()
    src, dst = simple_edges(u, v, graph.n)
    del u, v
    alpha, iters = inp["alpha"], inp["iterations"]
    ref = RP.pagerank(src, dst, graph.n, alpha, iters)
    gap = 0.0
    for _rec, ranks in samples:
        got = answer(src, dst, graph.n, alpha, iters) if answer is not None \
            else torch.from_numpy(ranks).to(graph.device)
        gap = max(gap, RP.max_relative_gap(got, ref))
    iters_diff = sum(int(r["summary"]["iterations"] != iters)
                     for r in records if r["ok"])
    per_job = inp["vertices"] + inp["edges"]
    work = [per_job if r["ok"] else None for r in records]
    return {"pagerank_rank_gap": gap,
            "pagerank_iterations_mismatch": iters_diff}, work
