"""A configuration's graph: made from the seed on the device, handed to
the system under test through its in-memory ingestion, and made again
for the reference once the measured window has closed.

The edge list is never written to disk and never cached between runs.
"""

from __future__ import annotations

import torch

from gbench import graphgen


class Graph:
    """The configuration's Kronecker graph for one seed."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg = cfg
        self.seed = int(seed)
        self.device = torch.device(device)
        self.scale = int(cfg["scale"])
        self.edgefactor = int(cfg["edgefactor"])
        self.n = 1 << self.scale
        self.m = self.edgefactor << self.scale

    def edges(self) -> tuple:
        """``(u, v)``: the input tuples on the device, the same on every
        call for one seed."""
        ini = self.cfg["initiator"]
        return graphgen.kronecker_edges(self.scale, self.edgefactor,
                                        self.seed, ini["A"], ini["B"],
                                        ini["C"], self.device)


def simple_edges(u: torch.Tensor, v: torch.Tensor, n: int) -> tuple:
    """The simple undirected graph of the tuples as directed half-edges
    ``(src, dst)`` (int64, both directions): self-loops dropped,
    duplicates merged, as Graph500's kernel 1 and LDBC Graphalytics'
    datasets read them."""
    lo = torch.minimum(u, v).to(torch.int64)
    hi = torch.maximum(u, v).to(torch.int64)
    keep = lo != hi
    key = torch.unique(lo[keep] * n + hi[keep])
    del lo, hi, keep
    a, b = key // n, key % n
    return torch.cat([a, b]), torch.cat([b, a])


def ingest(u: torch.Tensor, v: torch.Tensor, n: int):
    """The system under test's in-memory ingestion of the tuples: its
    native symmetrized, deduplicated chunked CSR, then its snapshot.
    Returns the snapshot the scheduler serves."""
    from titan_tpu_torch import native
    from titan_tpu_torch.olap import snapshot as SN

    src = u.cpu().numpy()
    dst = v.cpu().numpy()
    dstT, colstart, deg, _ = native.sym_chunked_csr(src, dst, n)
    del src, dst
    return SN.from_chunked_csr({"dstT": dstT, "colstart": colstart,
                                "deg": deg})
