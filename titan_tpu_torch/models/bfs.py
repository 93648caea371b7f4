"""Breadth-first search (unweighted hop count) as a DenseProgram (port of
``titan_tpu/models/bfs.py:1-58``): pull-mode supersteps,
dist' = min(dist, min over in-edges of dist[src] + 1), until no distance
changes."""

from __future__ import annotations

import numpy as np
import torch

from titan_tpu_torch.device import INF
from titan_tpu_torch.olap.api import DenseProgram


class BFS(DenseProgram):
    combine = "min"

    def __init__(self, max_iterations: int = 1000):
        self.max_iterations = max_iterations

    def init(self, n, params):
        dist = torch.full((n,), INF, dtype=torch.int32)
        dist[int(params["source_dense"])] = 0
        return {"dist": dist}

    def message(self, src_state, edge_data, params):
        d = src_state["dist"]
        return torch.where(d >= INF, INF, d + 1)

    def apply(self, state, agg, iteration, params):
        return {"dist": torch.minimum(state["dist"], agg)}

    def done(self, state, new_state, agg, iteration, params):
        return torch.equal(new_state["dist"], state["dist"])

    def outputs(self, state, params):
        return {"dist": state["dist"]}


def run(computer, source, snapshot=None, max_iterations: int = 1000):
    """``source``: original vertex id (graph mode) or dense index
    (snapshot mode)."""
    snap = snapshot or computer.snapshot()
    dense = snap.dense_of(source) if in_snapshot_ids(snap, source) \
        else int(source)
    prog = BFS(max_iterations)
    return computer.run(prog, params={"source_dense": dense}, snapshot=snap)


def in_snapshot_ids(snap, source) -> bool:
    i = np.searchsorted(snap.vertex_ids, source)
    return i < snap.n and snap.vertex_ids[i] == source
