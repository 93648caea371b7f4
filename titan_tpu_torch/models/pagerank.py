"""PageRank as a DenseProgram (port of ``titan_tpu/models/pagerank.py``,
the vertex-program part; the batched personalized PageRank is not
ported yet, ROADMAP queue 1, item 5). Pull-mode:

    rank' = (1-α)/n + α · Σ_{(u→v)} rank[u] / outdeg[u]
"""

from __future__ import annotations

import numpy as np
import torch

from titan_tpu_torch.olap.api import DenseMapReduce, DenseProgram


class PageRank(DenseProgram):
    combine = "sum"

    def __init__(self, alpha: float = 0.85, iterations: int = 20,
                 tol: float = 0.0):
        self.alpha = alpha
        self.max_iterations = iterations
        self.tol = tol

    def init(self, n, params):
        return {"rank": torch.full((n,), 1.0 / n, dtype=torch.float32),
                "inv_outdeg": params["inv_outdeg"]}

    def message(self, src_state, edge_data, params):
        return src_state["rank"] * src_state["inv_outdeg"]

    def apply(self, state, agg, iteration, params):
        # (1-α)/n as the JAX package computes it: both sides in float32
        # (a Python float over a tensor would multiply by 1/n instead);
        # a 0-d CPU tensor over the device's int32 n costs no copy
        base = torch.tensor(1.0 - self.alpha, dtype=torch.float32) \
            / params["n"]
        return {"rank": base + self.alpha * agg,
                "inv_outdeg": state["inv_outdeg"]}

    def done(self, state, new_state, agg, iteration, params):
        if self.tol <= 0.0:
            return False
        return (new_state["rank"] - state["rank"]).abs().max() < self.tol

    def outputs(self, state, params):
        return {"rank": state["rank"]}


class TopRanksMapReduce(DenseMapReduce):
    """Top-k ``(vertex id, rank)`` pairs, highest rank first; among equal
    ranks the lower dense index first, as ``jax.lax.top_k`` orders them."""

    memory_key = "pageRank"

    def __init__(self, k: int = 10):
        self.k = k

    def compute(self, state, snapshot, params):
        ranks = torch.as_tensor(state["rank"])
        k = min(self.k, ranks.shape[0])
        vals, idx = torch.sort(ranks, descending=True, stable=True)
        vids = np.asarray(snapshot.vertex_ids)[idx[:k].cpu().numpy()]
        return [(int(v), float(r)) for v, r in zip(vids, vals[:k].tolist())]


def run(computer, alpha: float = 0.85, iterations: int = 20, tol: float = 0.0,
        snapshot=None):
    snap = snapshot or computer.snapshot()
    outdeg = np.maximum(snap.out_degree, 1).astype(np.float32)
    inv = np.where(snap.out_degree > 0, 1.0 / outdeg, 0.0).astype(np.float32)
    prog = PageRank(alpha, iterations, tol)
    return computer.run(prog, params={"n": snap.n, "inv_outdeg": inv},
                        snapshot=snap)
