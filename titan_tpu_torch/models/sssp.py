"""Single-source shortest paths (weighted) as a DenseProgram (port of
``titan_tpu/models/sssp.py``): Bellman-Ford style message minimum over
weighted in-edges until stable. Reads the float32 edge weights from the
snapshot's ``edge_values``."""

from __future__ import annotations

import numpy as np
import torch

from titan_tpu_torch.olap.api import DenseMapReduce, DenseProgram

#: "unreached": float32(3.0e38), as a Python float that float32 holds
FINF = float(np.float32(3.0e38))


class MaxDistanceMapReduce(DenseMapReduce):
    """The largest finite distance reached from the source."""

    memory_key = "shortestDistance.max"

    def compute(self, state, snapshot, params):
        d = torch.as_tensor(state["dist"])
        return float(torch.where(d < FINF, d, float("-inf")).max())


class SSSP(DenseProgram):
    combine = "min"

    def __init__(self, weight_key: str = "weight", max_iterations: int = 1000):
        self.weight_key = weight_key
        self.max_iterations = max_iterations

    def edge_keys(self):
        return (self.weight_key,)

    def init(self, n, params):
        dist = torch.full((n,), FINF, dtype=torch.float32)
        dist[int(params["source_dense"])] = 0.0
        return {"dist": dist}

    def message(self, src_state, edge_data, params):
        w = edge_data[self.weight_key].to(torch.float32)
        d = src_state["dist"]
        return torch.where(d >= FINF, FINF, d + w)

    def apply(self, state, agg, iteration, params):
        return {"dist": torch.minimum(state["dist"], agg)}

    def done(self, state, new_state, agg, iteration, params):
        return torch.equal(new_state["dist"], state["dist"])

    def outputs(self, state, params):
        return {"dist": state["dist"]}


def run(computer, source, weight_key: str = "weight", snapshot=None,
        max_iterations: int = 1000):
    from titan_tpu_torch.models.bfs import in_snapshot_ids
    snap = snapshot or computer.snapshot(edge_keys=(weight_key,))
    dense = snap.dense_of(source) if in_snapshot_ids(snap, source) \
        else int(source)
    prog = SSSP(weight_key, max_iterations)
    return computer.run(prog, params={"source_dense": dense}, snapshot=snap)
