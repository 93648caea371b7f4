"""Weakly-connected components by min-label propagation as a
DenseProgram (port of ``titan_tpu/models/wcc.py``): label' = min(label,
min over in-edges of label[src]), on a symmetrized snapshot so the
components are weak."""

from __future__ import annotations

import torch

from titan_tpu_torch.olap.api import DenseProgram


class WCC(DenseProgram):
    combine = "min"

    def __init__(self, max_iterations: int = 1000):
        self.max_iterations = max_iterations

    def init(self, n, params):
        return {"label": torch.arange(n, dtype=torch.int32)}

    def message(self, src_state, edge_data, params):
        return src_state["label"]

    def apply(self, state, agg, iteration, params):
        return {"label": torch.minimum(state["label"], agg)}

    def done(self, state, new_state, agg, iteration, params):
        return torch.equal(new_state["label"], state["label"])

    def outputs(self, state, params):
        return {"label": state["label"]}


def run(computer, snapshot=None, max_iterations: int = 1000):
    snap = snapshot or computer.snapshot(directed=False)
    return computer.run(WCC(max_iterations), params={}, snapshot=snap)
