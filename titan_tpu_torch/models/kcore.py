"""k-core membership as a DenseProgram (port of
``titan_tpu/models/kcore.py``): a vertex stays in the k-core while at
least k of its neighbours are still in; each superstep sums the alive
in-neighbours and peels the vertices below k, until a fixed point. Runs
on the symmetrized snapshot."""

from __future__ import annotations

import torch

from titan_tpu_torch.olap.api import DenseProgram


class KCore(DenseProgram):
    combine = "sum"

    def __init__(self, k: int, max_iterations: int = 1000):
        self.k = k
        self.max_iterations = max_iterations

    def init(self, n, params):
        return {"alive": torch.ones((n,), dtype=torch.float32)}

    def message(self, src_state, edge_data, params):
        return src_state["alive"]

    def apply(self, state, agg, iteration, params):
        # peel: stay alive only with >= k alive neighbours
        return {"alive": ((state["alive"] > 0) & (agg >= self.k))
                .to(torch.float32)}

    def done(self, state, new_state, agg, iteration, params):
        return torch.equal(new_state["alive"], state["alive"])

    def outputs(self, state, params):
        return {"in_core": state["alive"] > 0}


def run(computer, k: int, snapshot=None, max_iterations: int = 1000):
    snap = snapshot or computer.snapshot(directed=False)
    return computer.run(KCore(k, max_iterations), snapshot=snap)
