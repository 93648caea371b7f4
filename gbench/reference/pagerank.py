"""Plain PageRank over the benchmark's own simple graph: the reference the
served ranks are held to.

Pull mode, as the configuration states it: every iteration

    rank'[v] = (1 - alpha) / n + alpha * sum over edges u -> v of
               rank[u] / outdeg[u]

from ``rank = 1 / n``, for a fixed number of iterations; a vertex with no
edge passes nothing on. In float64 by default. The control, one precision
below the configuration's float32, holds ranks and messages in bfloat16
(``dtype``) and adds them in float32 (``acc_dtype``), as a bfloat16
kernel with float32 accumulators would.

It imports nothing of the system under test.
"""

from __future__ import annotations

import torch


def pagerank(src: torch.Tensor, dst: torch.Tensor, n: int, alpha: float,
             iterations: int, dtype=torch.float64,
             acc_dtype=None) -> torch.Tensor:
    acc_dtype = acc_dtype or dtype
    dev = src.device
    outdeg = torch.zeros(n, dtype=torch.int64, device=dev)
    outdeg.index_add_(0, src, torch.ones_like(src))
    inv = torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1).to(
        torch.float64), 0.0).to(dtype)
    rank = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    base = torch.tensor((1.0 - alpha) / n, dtype=dtype, device=dev)
    for _ in range(iterations):
        msg = (rank * inv).index_select(0, src).to(acc_dtype)
        agg = torch.zeros(n, dtype=acc_dtype, device=dev).index_add_(
            0, dst, msg)
        rank = (base + alpha * agg).to(dtype)
    return rank


def max_relative_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap of a vertex's rank from the reference's, as a share
    of the reference's (every reference rank is at least
    ``(1 - alpha) / n``)."""
    return float(((got.to(torch.float64) - ref.to(torch.float64)).abs()
                  / ref.to(torch.float64)).max())
