"""The dense read-only graph image the engine runs on (port of the parts
of ``titan_tpu/olap/tpu/snapshot.py`` that the engine reads).

Edges are stored dst-sorted (``dst`` ascending, the pull layout), and
``indptr_in`` indexes them per destination. Three constructors:
``from_arrays`` (an edge list, stable-sorted by destination, as the JAX
package's numpy branch does), ``from_numpy`` (the arrays of any snapshot
with the same fields, such as the JAX package's) and
``from_chunked_csr`` (the port's symmetric Graph500 graph, with no host
sort). ``out_csr`` gives the source-sorted view that the chunked BFS
layout and the live overlay's slot lookup read. ``merge_delta`` is the
epoch compactor's host-durable sync: the dst-sorted merge of a delta
with no re-sort, carrying ``out_csr``'s cache over incrementally. The
OLTP build, refresh and ``attach_vertex_values`` are not ported
(ROADMAP queue 1, item 6b).
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
    # name -> (values object-array [n], present bool [n]): dense vertex
    # property columns, read by the interactive lane's values() terminal
    vertex_values: dict = field(default_factory=dict)
    # the graph's mutation epoch this image reflects (carried over by the
    # epoch compactor)
    epoch: int = 0
    _build_params: dict = field(default_factory=dict)
    # device -> olap/engine.DeviceGraph, filled by engine.device_graph
    _device_graphs: dict = field(default_factory=dict, init=False,
                                 repr=False, compare=False)
    # device -> chunked-CSR dict, filled by models/bfs_hybrid
    # .build_chunked_csr (the serving scheduler's eviction deletes it)
    _hybrid_csr_by_device: dict = field(default_factory=dict, init=False,
                              repr=False, compare=False)
    # the interactive lane's device caches, by device: the reversed
    # chunked CSR of out() chains and the per-hop label masks
    # (olap/serving/interactive/compile.py); the scheduler's eviction
    # deletes them
    _hybrid_csr_rev_by_device: dict = field(default_factory=dict,
                                            init=False, repr=False,
                                            compare=False)
    _hop_label_masks_by_device: dict = field(default_factory=dict,
                                             init=False, repr=False,
                                             compare=False)
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
    the JAX package's), so both engines can run on the same arrays;
    ``vertex_values`` and ``epoch`` are copied too."""
    out = GraphSnapshot(
        int(snap.n), np.array(snap.vertex_ids, dtype=np.int64),
        np.array(snap.src, dtype=np.int32),
        np.array(snap.dst, dtype=np.int32),
        np.array(snap.indptr_in, dtype=np.int64),
        np.array(snap.out_degree, dtype=np.int32),
        {k: np.array(v) for k, v in snap.edge_values.items()},
        None if snap.labels is None else np.array(snap.labels,
                                                  dtype=np.int32),
        dict(snap.label_names))
    out.vertex_values = {k: (np.array(vals), np.array(present, dtype=bool))
                         for k, (vals, present)
                         in getattr(snap, "vertex_values", {}).items()}
    out.epoch = int(getattr(snap, "epoch", 0))
    return out


def merge_delta(snap: GraphSnapshot, keep: np.ndarray, add_src, add_dst,
                add_labels=None) -> GraphSnapshot:
    """Incremental dst-sorted merge: drop the rows where ``keep`` is False
    and insert the added edges WITHOUT re-sorting the surviving rows.
    Bit-equal to ``from_arrays(n, concat(src[keep], add_src),
    concat(dst[keep], add_dst), ...)``: the kept rows stay dst-ascending,
    and a stable dst-sort puts equal-dst adds AFTER the kept rows in
    append order, which is a ``side='right'`` searchsorted insert. O(E)
    memcpy + O(delta log delta). When ``snap`` has ``out_csr``'s cache,
    the merged snapshot gets its own, built incrementally
    (``_merge_out_csr``). The epoch compactor's device path runs this
    every epoch."""
    add_src = np.asarray(add_src, np.int32)
    add_dst = np.asarray(add_dst, np.int32)
    if len(add_src) and (int(add_src.min()) < 0
                        or int(add_src.max()) >= snap.n
                        or int(add_dst.min()) < 0
                        or int(add_dst.max()) >= snap.n):
        raise IndexError(f"edge endpoint out of range [0, {snap.n})")
    order = np.argsort(add_dst, kind="stable")
    a_s, a_d = add_src[order], add_dst[order]
    dst_kept = snap.dst[keep]
    pos = np.searchsorted(dst_kept, a_d, side="right")
    src = np.insert(snap.src[keep], pos, a_s)
    dst = np.insert(dst_kept, pos, a_d)
    labels = None
    if snap.labels is not None:
        a_l = np.asarray(add_labels, np.int32)[order] \
            if add_labels is not None \
            else np.zeros(len(a_s), np.int32)
        labels = np.insert(snap.labels[keep], pos, a_l)
    counts = np.diff(snap.indptr_in)
    dead_dst = snap.dst[~keep].astype(np.int64)
    if len(dead_dst):
        np.add.at(counts, dead_dst, -1)
    if len(a_d):
        np.add.at(counts, a_d.astype(np.int64), 1)
    indptr_in = np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(counts, dtype=np.int64)])
    out_degree = snap.out_degree.copy()
    dead_src = snap.src[~keep].astype(np.int64)
    if len(dead_src):
        np.add.at(out_degree, dead_src, -1)
    if len(a_s):
        np.add.at(out_degree, a_s.astype(np.int64), 1)
    merged = GraphSnapshot(snap.n, snap.vertex_ids, src, dst, indptr_in,
                           out_degree, {}, labels, dict(snap.label_names))
    if getattr(snap, "_out_csr", None) is not None \
            and getattr(snap, "_out_csr_order", None) is not None:
        _merge_out_csr(snap, merged, keep, add_src, add_dst, pos)
    return merged


def _merge_out_csr(snap: GraphSnapshot, merged: GraphSnapshot,
                   keep: np.ndarray, add_src: np.ndarray,
                   add_dst: np.ndarray, pos_d: np.ndarray) -> None:
    """The merged snapshot's ``_out_csr`` (dst_by_src, indptr_out) and
    ``_out_csr_order`` from the base's cached pair: O(E) gathers +
    O(delta log delta) sorts, bit-equal to a fresh ``out_csr()`` on the
    merged arrays. A stable src-sort keeps dst order within each source
    (the merged array is dst-ascending), kept rows keep their relative
    order, and equal-(src, dst) adds land AFTER kept rows in append
    order: a ``side='right'`` insert on the (src, dst) key. ``pos_d`` is
    ``merge_delta``'s dst-order insert positions (the adds' merged rows
    are ``pos_d + arange``)."""
    dst_by_src_old, _ = snap._out_csr
    order_old = snap._out_csr_order
    n = snap.n
    keep_s = keep[order_old]                  # keep mask, src order
    kept_dst_s = dst_by_src_old[keep_s]
    # in src order the sources are each vertex repeated by its OLD
    # out-degree: no sort needed
    src_sorted_old = np.repeat(np.arange(n, dtype=np.int64),
                               snap.out_degree.astype(np.int64))
    kept_src_s = src_sorted_old[keep_s]
    # adds in (src, dst, append) order: a stable dst-sort, then a stable
    # src-sort
    o1 = np.argsort(add_dst, kind="stable")
    o = o1[np.argsort(add_src[o1], kind="stable")]
    as_s, ad_s = add_src[o].astype(np.int64), add_dst[o]
    key_kept = kept_src_s * np.int64(n + 1) + kept_dst_s
    key_add = as_s * np.int64(n + 1) + ad_s
    pos_s = np.searchsorted(key_kept, key_add, side="right")
    dst_by_src_new = np.insert(kept_dst_s, pos_s, ad_s)
    indptr_out_new = np.concatenate(
        [np.zeros(1, np.int64),
         np.cumsum(merged.out_degree, dtype=np.int64)])
    # merged row of each src-order position: kept row j (in kept-dst
    # order) shifts by the adds inserted at or before it; dst-order add
    # k lands at pos_d[k] + k
    kept_rank = np.cumsum(keep, dtype=np.int64) - 1
    j_kept = kept_rank[order_old[keep_s]]
    merged_idx_kept = j_kept + np.searchsorted(pos_d, j_kept, side="right")
    merged_idx_add_d = pos_d.astype(np.int64) \
        + np.arange(len(pos_d), dtype=np.int64)
    ord_d = np.argsort(add_dst, kind="stable")
    rank_d = np.empty(len(ord_d), np.int64)
    rank_d[ord_d] = np.arange(len(ord_d), dtype=np.int64)
    merged_idx_add_s = merged_idx_add_d[rank_d[o]]
    order_new = np.insert(merged_idx_kept, pos_s, merged_idx_add_s)
    merged._out_csr = (dst_by_src_new, indptr_out_new)
    merged._out_csr_order = order_new


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
