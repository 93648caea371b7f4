"""The dense read-only graph image the engine runs on (port of the parts
of ``titan_tpu/olap/tpu/snapshot.py`` that the engine reads).

Edges are stored dst-sorted (``dst`` ascending, the pull layout), and
``indptr_in`` indexes them per destination. Three constructors:
``from_arrays`` (an edge list, stable-sorted by destination, as the JAX
package's numpy branch does), ``from_numpy`` (the arrays of any snapshot
with the same fields, such as the JAX package's) and
``from_chunked_csr`` (the port's symmetric Graph500 graph, with no host
sort). ``out_csr`` gives the source-sorted view that the chunked BFS
layout and the live overlay's slot lookup read. The OLTP build, refresh
and the live-plane merges are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class GraphSnapshot:
    n: int
    vertex_ids: np.ndarray          # [n] int64, original ids, ascending
    src: np.ndarray                 # [E] int32 dense indices, dst-sorted
    dst: np.ndarray                 # [E] int32 dense indices, ascending
    indptr_in: np.ndarray           # [n+1] int64
    out_degree: np.ndarray          # [n] int32
    edge_values: dict = field(default_factory=dict)  # name -> [E] array
    labels: Optional[np.ndarray] = None              # [E] int32 label codes
    label_names: dict = field(default_factory=dict)  # code -> label name
    # device -> olap/engine.DeviceGraph, filled by engine.device_graph
    _device_graphs: dict = field(default_factory=dict, init=False,
                                 repr=False, compare=False)
    # device -> chunked-CSR dict, filled by models/bfs_hybrid
    # .build_chunked_csr (the serving scheduler's eviction deletes it)
    _hybrid_csr_by_device: dict = field(default_factory=dict, init=False,
                              repr=False, compare=False)
    # out_csr's cache: (dst_by_src, indptr_out) and the src-order
    # permutation (src-order position -> dst-order row)
    _out_csr: Optional[tuple] = field(default=None, init=False, repr=False,
                                      compare=False)
    _out_csr_order: Optional[np.ndarray] = field(default=None, init=False,
                                                 repr=False, compare=False)

    @property
    def num_edges(self) -> int:
        return len(self.src)

    def dense_of(self, vertex_id: int) -> int:
        i = int(np.searchsorted(self.vertex_ids, vertex_id))
        if i >= self.n or self.vertex_ids[i] != vertex_id:
            raise KeyError(f"vertex {vertex_id} not in snapshot")
        return i

    def out_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """``(dst_by_src, indptr_out)``: the edges sorted by SOURCE, the
        push/expansion layout. A stable argsort by ``src``, so each
        source's edges keep their dst-sorted order (the JAX package's
        native counting sort is stable too and gives the same order).
        Computed once and cached with the permutation itself,
        ``_out_csr_order`` (src-order position -> dst-order row), which
        the live overlay's slot lookup reads."""
        if self._out_csr is None:
            indptr_out = np.concatenate(
                [np.zeros(1, np.int64),
                 np.cumsum(self.out_degree, dtype=np.int64)])
            order = np.argsort(self.src, kind="stable")
            self._out_csr = (self.dst[order], indptr_out)
            self._out_csr_order = order.astype(np.int64)
        return self._out_csr

    def reverse(self) -> "GraphSnapshot":
        """Swap edge direction (push layout / in-degree programs)."""
        return from_arrays(self.n, self.dst, self.src, self.vertex_ids,
                           edge_values=self.edge_values, labels=self.labels,
                           label_names=self.label_names)


def from_arrays(n: int, src, dst, vertex_ids=None, edge_values=None,
                labels=None, label_names=None) -> GraphSnapshot:
    """Build a snapshot from raw (src, dst) dense-index arrays."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if len(src) and (int(src.min()) < 0 or int(src.max()) >= n
                     or int(dst.min()) < 0 or int(dst.max()) >= n):
        raise IndexError(f"edge endpoint out of range [0, {n})")
    if vertex_ids is None:
        vertex_ids = np.arange(n, dtype=np.int64)
    order = np.argsort(dst, kind="stable")
    src_s, dst_s = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst_s, minlength=n), out=indptr[1:])
    out_degree = np.bincount(src, minlength=n).astype(np.int32)
    ev = {k: np.asarray(v)[order] for k, v in (edge_values or {}).items()}
    lab = (np.asarray(labels, dtype=np.int32)[order]
           if labels is not None else None)
    return GraphSnapshot(n, np.asarray(vertex_ids, dtype=np.int64), src_s,
                         dst_s, indptr, out_degree, ev, lab,
                         dict(label_names or {}))


def from_numpy(snap) -> GraphSnapshot:
    """A port snapshot holding copies of the numpy fields of ``snap``
    (duck-typed: any object with the ``GraphSnapshot`` fields, such as
    the JAX package's), so both engines can run on the same arrays."""
    return GraphSnapshot(
        int(snap.n), np.array(snap.vertex_ids, dtype=np.int64),
        np.array(snap.src, dtype=np.int32),
        np.array(snap.dst, dtype=np.int32),
        np.array(snap.indptr_in, dtype=np.int64),
        np.array(snap.out_degree, dtype=np.int32),
        {k: np.array(v) for k, v in snap.edge_values.items()},
        None if snap.labels is None else np.array(snap.labels,
                                                  dtype=np.int32),
        dict(snap.label_names))


def from_chunked_csr(host_graph: dict) -> GraphSnapshot:
    """The dst-sorted snapshot of a symmetric chunked CSR
    (``olap/graph500.load_or_build``: ``dstT`` [8, Q] lane-major with pad
    ``n+1``, ``colstart`` [n+1], ``deg`` [n]), with no host sort.

    In a symmetric graph the in-edges of ``v`` are its CSR row, so
    ``dst`` is ``v`` repeated ``deg[v]`` times and ``src`` is the row. The
    chunk-major order of ``dstT`` (its transpose) lists the rows one after
    another, each followed by its pad slots. ``from_arrays`` over the
    half-edge list in CSR order gives each row in ascending source order;
    both ``load_or_build`` generators emit sorted rows, and a row that is
    not is sorted here, so the result equals ``from_arrays`` bit for
    bit."""
    dstT = np.asarray(host_graph["dstT"])
    deg = np.asarray(host_graph["deg"], dtype=np.int32)
    n = deg.shape[0]
    slots = np.ascontiguousarray(dstT.T).reshape(-1)
    src = slots[slots != n + 1]
    del slots
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    if src.shape[0] != indptr[-1]:
        raise ValueError(f"chunked CSR holds {src.shape[0]} neighbours, "
                         f"its degrees sum to {int(indptr[-1])}")
    dst = np.repeat(np.arange(n, dtype=np.int32), deg)
    unsorted = (src[1:] < src[:-1]) & (dst[1:] == dst[:-1])
    if unsorted.any():
        src = src[np.lexsort((src, dst))]
    return GraphSnapshot(n, np.arange(n, dtype=np.int64), src, dst, indptr,
                         deg.copy())
