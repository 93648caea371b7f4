"""PageRank as a DenseProgram, the batched personalized PageRank and its
per-user top-k (port of ``titan_tpu/models/pagerank.py``). Pull-mode:

    rank' = (1-α)/n + α · Σ_{(u→v)} rank[u] / outdeg[u]
"""

from __future__ import annotations

import numpy as np
import torch

from titan_tpu_torch.models import frontier as FR
from titan_tpu_torch.obs import devprof
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


def pagerank_personalized_batched(snap_or_graph, sources=None,
                                  iterations: int = 20,
                                  damping: float = 0.85, reset=None,
                                  return_device: bool = False,
                                  on_round=None, overlay=None, device=None):
    """Batched personalized PageRank: one reset row per user over the
    dense column windows; each window's owners and scatter targets are
    built once and serve every row. ``sources``: dense vertex indices, row
    s teleporting to (and starting at) the one-hot of ``sources[s]``;
    ``reset`` ([S, n], rows summing to 1) overrides them. Each row runs
    exactly the operations of ``frontier.pagerank_dense(reset=row)``, one
    row at a time (a flat [S, 8, W] int64 index would take 4.3 GB at S =
    16 and W = 2^22), so on the CPU it is bit-equal to that run; on a
    card the scatter-adds add in no fixed order. ``on_round(it)``:
    per-iteration veto (``frontier.RoundInterrupted``); no per-row
    ``tol``. Refuses a non-empty live overlay. Returns ``(ranks [S, n],
    iterations)``."""
    g, deg = FR._pr_setup(snap_or_graph, overlay, device,
                          "pagerank_personalized_batched")
    n = g["n"]
    dev = g["dstT"].device
    if reset is not None:
        r = FR._as_state(reset, torch.float32, dev)
        if r.dim() != 2 or r.shape[1] != n:
            raise ValueError(f"reset must be [S, n={n}], got "
                             f"{tuple(r.shape)}")
        S = r.shape[0]
        reset_dev = torch.cat([r, r.new_zeros((S, 1))], dim=1)
    else:
        if sources is None or len(sources) == 0:
            raise ValueError("need sources (dense indices) or reset "
                             "rows — one per user")
        src = np.asarray(sources, np.int64)
        if src.min() < 0 or src.max() >= n:
            raise IndexError(f"source out of range [0, {n})")
        S = len(src)
        reset_dev = torch.zeros((S, n + 1), dtype=torch.float32, device=dev)
        reset_dev[torch.arange(S, device=dev),
                  torch.from_numpy(src).to(dev)] = 1.0
    rank = reset_dev
    contrib = FR._pr_contrib(rank, deg)
    windows = FR._pr_windows(g)
    it = 0
    for it in range(1, iterations + 1):
        if on_round is not None and not on_round(it - 1):
            raise FR.RoundInterrupted(it - 1)
        acc = FR._acc((S,), g)
        for w0, w1 in windows:
            plan = FR._pr_window_plan(g, w0, w1)
            for s in range(S):
                FR._pr_window_add(acc[s], contrib[s], plan)
            del plan
        rows = [FR._pr_finish_reset(acc[s], rank[s], reset_dev[s], deg,
                                    damping, n) for s in range(S)]
        rank = torch.stack([r[0] for r in rows])
        contrib = torch.stack([r[1] for r in rows])
        del acc, rows
    out = rank[:, :n]
    if return_device:
        return out, it
    devprof.count_d2h("frontier.result", out.numel() * out.element_size())
    return out.cpu().numpy(), it


def top_k_per_user(ranks, vertex_ids, k: int = 10, exclude=None):
    """Per-user top-k ``(vertex id, rank)`` rows from a batched PPR result
    ([S, n], an array or a tensor). ``exclude`` (optional [S]-list of
    dense indices, typically each user's own source) drops that vertex
    from the user's ranking. Zero ranks are never recommended; equal
    ranks keep the order ``np.argpartition`` leaves them in, as in the
    JAX package (this is its numpy code)."""
    ranks = ranks.cpu().numpy() if torch.is_tensor(ranks) \
        else np.asarray(ranks)
    S, n = ranks.shape
    k = min(int(k), n)
    if k <= 0:
        return [[] for _ in range(S)]
    out = []
    for s in range(S):
        row = ranks[s]
        if exclude is not None and exclude[s] is not None:
            row = row.copy()
            row[exclude[s]] = -1.0
        idx = np.argpartition(-row, k - 1)[:k]
        idx = idx[np.argsort(-row[idx], kind="stable")]
        out.append([(int(vertex_ids[i]), float(ranks[s][i]))
                    for i in idx if row[i] > 0.0])
    return out


def run(computer, alpha: float = 0.85, iterations: int = 20, tol: float = 0.0,
        snapshot=None):
    snap = snapshot or computer.snapshot()
    outdeg = np.maximum(snap.out_degree, 1).astype(np.float32)
    inv = np.where(snap.out_degree > 0, 1.0 / outdeg, 0.0).astype(np.float32)
    prog = PageRank(alpha, iterations, tol)
    return computer.run(prog, params={"n": snap.n, "inv_outdeg": inv},
                        snapshot=snap)
