"""HITS (hubs and authorities) as a DenseProgram (port of
``titan_tpu/models/hits.py``). The engine combines per destination, so
the snapshot carries both edge directions with a per-edge ``fwd`` flag
and the half-steps alternate:

  even superstep: authority[v] = Σ hub[u]       over forward edges u→v
  odd  superstep: hub[u]       = Σ authority[v] over backward edges v→u

The phase is a per-vertex state array (all equal), so ``message``, which
sees only per-edge source state, can mask the inactive direction. Each
half-step is L2-normalised over the whole graph (one device: a plain
sum).
"""

from __future__ import annotations

import numpy as np
import torch

from titan_tpu_torch.olap.api import DenseProgram


class HITS(DenseProgram):
    combine = "sum"

    def __init__(self, iterations: int = 20):
        # one HITS round = two engine supersteps (authority, then hub)
        self.max_iterations = 2 * iterations

    def edge_keys(self):
        return ("fwd",)

    def init(self, n, params):
        return {"hub": torch.ones((n,), dtype=torch.float32),
                "auth": torch.ones((n,), dtype=torch.float32),
                # 1.0 = even phase (authority update)
                "phase": torch.ones((n,), dtype=torch.float32)}

    def message(self, src_state, edge_data, params):
        fwd = edge_data["fwd"].to(torch.float32)
        p = src_state["phase"]
        return p * fwd * src_state["hub"] + \
            (1.0 - p) * (1.0 - fwd) * src_state["auth"]

    def apply(self, state, agg, iteration, params):
        even = state["phase"][0] > 0.5     # a device scalar, no readback
        s = torch.sqrt((agg * agg).sum())
        nagg = torch.where(s > 0, agg / s, agg)
        return {"hub": torch.where(even, state["hub"], nagg),
                "auth": torch.where(even, nagg, state["auth"]),
                "phase": 1.0 - state["phase"]}

    def outputs(self, state, params):
        return {"hub": state["hub"], "auth": state["auth"]}


def run(computer, iterations: int = 20, snapshot=None):
    """Run on a bidirectional snapshot (forward + backward edges with the
    ``fwd`` flag); without one, the computer's snapshot is doubled here."""
    if snapshot is None:
        base = computer.snapshot()
        snapshot = bidirectional_snapshot(base.n, base.src, base.dst,
                                          vertex_ids=base.vertex_ids)
    return computer.run(HITS(iterations), params={}, snapshot=snapshot)


def bidirectional_snapshot(n, src, dst, vertex_ids=None):
    """Forward+backward edge list with the ``fwd`` flag HITS needs."""
    from titan_tpu_torch.olap.snapshot import from_arrays
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    fwd = np.concatenate([np.ones(len(src), np.float32),
                          np.zeros(len(dst), np.float32)])
    return from_arrays(n, np.concatenate([src, dst]),
                       np.concatenate([dst, src]), vertex_ids=vertex_ids,
                       edge_values={"fwd": fwd})
