"""The dense read-only graph image the engine runs on (the port of
``titan_tpu/olap/tpu/snapshot.py``).

Edges are stored dst-sorted (``dst`` ascending, the pull layout), and
``indptr_in`` indexes them per destination. Four constructors: ``build``
(the store scan of a graph, with the JAX package's epoch discipline),
``from_arrays`` (an edge list, stable-sorted by destination by the
native counting sort, as the JAX package does), ``from_numpy`` (the
arrays of any snapshot with the same fields, such as the JAX package's)
and ``from_chunked_csr`` (the port's symmetric Graph500 graph, with no
host sort). ``out_csr`` gives the source-sorted view that the chunked
BFS layout and the live overlay's slot lookup read. ``merge_delta`` is
the epoch compactor's host-durable sync: the dst-sorted merge of a delta
with no re-sort, carrying ``out_csr``'s cache over incrementally.

A built snapshot keeps its graph: ``stale`` says commits landed after
its ``epoch``, ``refresh()`` applies them from its change listener
without a store scan, ``rebuild_in_place()`` re-scans, and ``close()``
detaches the listener. Each drops the snapshot's derived layouts and
device caches where the JAX package drops its own; the device caches
keep the port's names (``_device_graphs``, ``_hybrid_csr_by_device``,
``_hybrid_csr_rev_by_device``, ``_hop_label_masks_by_device``, and the
push-frontier BFS's ``_frontier_csr_by_device``,
``_tiled_shards_by_device`` and ``_out_degree_by_device``), since tests
hand one snapshot object to both packages.

The scan dispatches as the JAX package's does: ``edge_keys`` take the
Python codec (``_scan_python``), a store without packed ops the
entry-wise native scan and every other store the packed native scan.
The native library is always built; a failed build raises.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from titan_tpu_torch import native
from titan_tpu_torch.codec import relation_ids as rids
from titan_tpu_torch.core.defs import Cardinality, Direction, RelationCategory
from titan_tpu_torch.ids import IDType
from titan_tpu_torch.storage.api import Entry, SliceQuery


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
    # the graph's mutation epoch this image reflects (see refresh(); the
    # epoch compactor carries it over)
    epoch: int = 0
    # the source graph and the change listener build() subscribed
    _graph: object = field(default=None, repr=False, compare=False)
    _listener_token: int = field(default=0, repr=False, compare=False)
    _listener: Optional[list] = field(default=None, repr=False,
                                      compare=False)
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
    # the push-frontier BFS's device caches, by device
    # (models/bfs.py): the out-CSR, the tiled shards and the out-degrees
    _frontier_csr_by_device: dict = field(default_factory=dict, init=False,
                                          repr=False, compare=False)
    _tiled_shards_by_device: dict = field(default_factory=dict, init=False,
                                          repr=False, compare=False)
    _out_degree_by_device: dict = field(default_factory=dict, init=False,
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

    @property
    def stale(self) -> bool:
        """True when commits landed on the source graph after this
        snapshot's epoch."""
        g = self._graph
        return g is not None and self.epoch < g.mutation_epoch

    def close(self) -> None:
        """Detach the change listener (stops delta accumulation)."""
        g = self._graph
        if g is not None and self._listener_token:
            g.unsubscribe_changes(self._listener_token)
            self._graph = None
            self._listener = None

    def refresh(self) -> dict:
        """Apply the commits since ``epoch`` to this snapshot in memory,
        with no store scan: pure edge additions merge into the dst-sorted
        arrays; vertex changes and edge removals rebuild the CSR from the
        patched edge list. Derived layouts and device caches are dropped.
        Returns the counts of ``apply_changes``.

        Only commits on this graph instance are seen (the in-process
        listener's); raises RuntimeError on a backlog overflow or a gap
        in the epochs (commits during build()'s scan), and
        NotImplementedError with extracted ``edge_values``: rebuild then
        (``rebuild_in_place``)."""
        g = self._graph
        if g is None:
            raise RuntimeError("snapshot has no source graph "
                               "(built from_arrays or closed)")
        if self.edge_values:
            raise NotImplementedError(
                "refresh() with extracted edge_values: change payloads "
                "don't carry edge properties — rebuild the snapshot")
        q = self._listener
        if getattr(q, "overflowed", False):
            raise RuntimeError(
                "change backlog overflowed (>10k commits since the last "
                "refresh) — delta refresh is unsound; rebuild the "
                "snapshot")
        new_epoch = g.mutation_epoch
        # drain up to new_epoch only: a commit racing this refresh may
        # queue payloads past it, which stay for the next refresh
        cut = 0
        while cut < len(q) and (q[cut].get("epoch") is None
                                or q[cut]["epoch"] <= new_epoch):
            cut += 1
        pending = list(q[:cut])
        del q[:cut]
        # the payloads must cover exactly (self.epoch, new_epoch]: a gap
        # means commits this listener never saw
        epochs = [p.get("epoch") for p in pending]
        covered = [e for e in epochs if e is not None
                   and self.epoch < e <= new_epoch]
        if len(covered) != new_epoch - self.epoch:
            raise RuntimeError(
                f"snapshot delta gap: epochs ({self.epoch}, {new_epoch}] "
                f"but only {len(covered)} payloads — commits landed "
                "concurrently with build()'s scan; rebuild the snapshot")
        stats = self.apply_changes(
            [p for p in pending
             if p.get("epoch") is None or p["epoch"] > self.epoch],
            g.schema, g.idm)
        self.epoch = new_epoch
        return stats

    def rebuild_in_place(self) -> None:
        """A full store scan adopted into this object, the recovery path
        when a delta refresh is unsound. The change queue is re-anchored
        at the rebuilt epoch (cleared, overflow reset) under the same
        commit-lock window that verifies the scan, so later refresh()es
        take the delta path again. The caller guarantees that no device
        run is reading the arrays (the pool takes this path with no
        leases out)."""
        g = self._graph
        if g is None:
            raise RuntimeError("snapshot has no source graph "
                               "(built from_arrays or closed)")
        p = self._build_params or {}
        fresh = build(g, labels=p.get("labels"),
                      edge_keys=p.get("edge_keys", ()),
                      directed=p.get("directed", True),
                      _reuse_listener=(self._listener_token,
                                       self._listener))
        self.n = fresh.n
        self.vertex_ids = fresh.vertex_ids
        self.src, self.dst = fresh.src, fresh.dst
        self.indptr_in = fresh.indptr_in
        self.out_degree = fresh.out_degree
        self.edge_values = fresh.edge_values
        self.labels = fresh.labels
        self.label_names = fresh.label_names
        # the vertex set may have changed: every dense column and derived
        # layout is invalid
        self.vertex_values.clear()
        self._invalidate_layout_caches()
        self.epoch = fresh.epoch
        # fresh shares our (reused) listener: detach it, so that fresh's
        # close cannot unregister the queue we keep using
        fresh._graph = None
        fresh._listener = None
        fresh._listener_token = 0

    def apply_changes(self, payloads: list, schema, idm) -> dict:
        """Apply change payloads (``core/changes.change_payload`` dicts)
        to the in-memory CSR."""
        params = self._build_params or {}
        label_ids = params.get("label_ids")
        directed = params.get("directed", True)
        add_src: list = []
        add_dst: list = []
        add_lab: list = []
        removed_edges: list = []
        new_vids: set = set()
        dead_vids: set = set()
        prop_keys: set = set()
        for p in payloads:
            for r in (*p.get("added", ()), *p.get("removed", ())):
                if "in" not in r:          # property mutation
                    prop_keys.add(r.get("type"))
            for vid in p.get("added_vertices", ()):
                new_vids.add(idm.canonical_vertex_id(vid))
            for vid in p.get("removed_vertices", ()):
                dead_vids.add(idm.canonical_vertex_id(vid))
            for r in p.get("added", ()):
                if "in" not in r:
                    continue                      # property, not an edge
                st = schema.get_by_name(r["type"])
                if st is None or (label_ids is not None
                                  and st.id not in label_ids):
                    continue
                add_src.append(idm.canonical_vertex_id(r["out"]))
                add_dst.append(idm.canonical_vertex_id(r["in"]))
                add_lab.append(idm.count(st.id))
                self.label_names.setdefault(idm.count(st.id), st.name)
            for r in p.get("removed", ()):
                if "in" not in r:
                    continue
                st = schema.get_by_name(r["type"])
                if st is None:
                    continue
                removed_edges.append(
                    (idm.canonical_vertex_id(r["out"]),
                     idm.canonical_vertex_id(r["in"]), idm.count(st.id)))
        new_vids -= set(self.vertex_ids.tolist())
        stats = {"added_edges": len(add_src),
                 "removed_edges": len(removed_edges),
                 "added_vertices": len(new_vids),
                 "removed_vertices": len(dead_vids)}
        # a property mutation invalidates its dense column even when no
        # edge or vertex changed
        for k in prop_keys:
            self.vertex_values.pop(k, None)
        if not (add_src or removed_edges or new_vids or dead_vids):
            return stats

        self._invalidate_layout_caches()
        need_rebuild = bool(removed_edges or new_vids or dead_vids)
        if need_rebuild:
            # the vertex set changes: every dense column is misaligned
            self.vertex_values.clear()
        if not need_rebuild:
            self._merge_edges(np.asarray(add_src, np.int64),
                              np.asarray(add_dst, np.int64),
                              np.asarray(add_lab, np.int32), directed)
            return stats

        # general path: patch the edge list, re-densify, rebuild. The
        # rows stay dense: old vertex v becomes remap[v] when alive[v].
        # The JAX package maps every row's id through a binary search
        # over the new ids; here only the old ids and the adds are
        # searched (the same rows, in the same order)
        old_ids = self.vertex_ids
        ids = np.asarray(sorted((set(old_ids.tolist()) | new_vids)
                                - dead_vids), np.int64)

        def dense(vids):
            """(index into ids, present) for each id of ``vids``."""
            at = np.clip(np.searchsorted(ids, vids), 0, max(len(ids) - 1, 0))
            if not len(ids):
                return at, np.zeros(len(vids), bool)
            return at, ids[at] == vids

        remap, alive = dense(old_ids)
        src0 = self.src.astype(np.int64)
        dst0 = self.dst.astype(np.int64)
        labs = self.labels if self.labels is not None \
            else np.zeros(len(src0), np.int32)
        keep = np.ones(len(src0), bool)
        if removed_edges:
            # drop ONE row per removed relation per direction (parallel
            # edges are distinct relations), the first matching rows in
            # row order; an undirected snapshot holds both rows of every
            # relation, so each removal is wanted under both keys. Only
            # rows whose source is a wanted source are visited (the JAX
            # package visits every row: the same rows drop)
            want = Counter(removed_edges)
            if not directed:
                want.update((d, s, lb) for s, d, lb in removed_edges)
            wanted = np.flatnonzero(np.isin(
                old_ids, np.fromiter({k[0] for k in want}, np.int64)))
            for i in np.flatnonzero(np.isin(src0, wanted)).tolist():
                key = (int(old_ids[src0[i]]), int(old_ids[dst0[i]]),
                       int(labs[i]))
                if want.get(key, 0) > 0:
                    want[key] -= 1
                    keep[i] = False
        if dead_vids:
            keep &= alive[src0] & alive[dst0]
        src0, dst0, labs = src0[keep], dst0[keep], labs[keep]
        si, di = remap[src0], remap[dst0]
        # drop rows whose endpoint is not a live vertex, as build() does
        ok = alive[src0] & alive[dst0]
        del src0, dst0
        if add_src:
            a_s = np.asarray(add_src, np.int64)
            a_d = np.asarray(add_dst, np.int64)
            a_l = np.asarray(add_lab, np.int32)
            if not directed:
                a_s, a_d = (np.concatenate([a_s, a_d]),
                            np.concatenate([a_d, a_s]))
                a_l = np.concatenate([a_l, a_l])
            (a_si, a_ok), (a_di, d_ok) = dense(a_s), dense(a_d)
            si = np.concatenate([si, a_si])
            di = np.concatenate([di, a_di])
            labs = np.concatenate([labs, a_l])
            ok = np.concatenate([ok, a_ok & d_ok])
        si, di, labs = si[ok], di[ok], labs[ok]
        rebuilt = from_arrays(len(ids), si.astype(np.int32),
                              di.astype(np.int32), ids, None, labs,
                              self.label_names)
        self.n = rebuilt.n
        self.vertex_ids = rebuilt.vertex_ids
        self.src, self.dst = rebuilt.src, rebuilt.dst
        self.indptr_in = rebuilt.indptr_in
        self.out_degree = rebuilt.out_degree
        self.labels = rebuilt.labels
        return stats

    def _merge_edges(self, src_ids, dst_ids, labs, directed) -> None:
        """Merge new edges of existing vertices into the dst-sorted
        arrays (one O(E) insert, no re-sort of the old rows)."""
        if not directed:
            src_ids, dst_ids = (np.concatenate([src_ids, dst_ids]),
                                np.concatenate([dst_ids, src_ids]))
            labs = np.concatenate([labs, labs])
        si = np.searchsorted(self.vertex_ids, src_ids)
        di = np.searchsorted(self.vertex_ids, dst_ids)
        ok = (si < self.n) & (di < self.n)
        ok &= (self.vertex_ids[np.minimum(si, self.n - 1)] == src_ids) \
            & (self.vertex_ids[np.minimum(di, self.n - 1)] == dst_ids)
        si, di, labs = (si[ok].astype(np.int32), di[ok].astype(np.int32),
                        labs[ok])
        order = np.argsort(di, kind="stable")
        si, di, labs = si[order], di[order], labs[order]
        pos = np.searchsorted(self.dst, di, side="right")
        self.src = np.insert(self.src, pos, si)
        self.dst = np.insert(self.dst, pos, di)
        if self.labels is not None:
            self.labels = np.insert(self.labels, pos, labs)
        counts = np.diff(self.indptr_in)
        np.add.at(counts, di.astype(np.int64), 1)
        self.indptr_in = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(counts, dtype=np.int64)])
        np.add.at(self.out_degree, si, 1)

    #: the device caches by device: the engine's edge arrays
    #: (olap/engine.device_graph), the chunked CSR
    #: (models/bfs_hybrid.build_chunked_csr) and the interactive lane's
    #: reversed layout and label masks (olap/serving/interactive/compile)
    _DEVICE_CACHES = ("_device_graphs", "_hybrid_csr_by_device",
                      "_hybrid_csr_rev_by_device",
                      "_hop_label_masks_by_device",
                      "_frontier_csr_by_device", "_tiled_shards_by_device",
                      "_out_degree_by_device")

    def _invalidate_layout_caches(self) -> None:
        """Drop out_csr's pair and every device cache (each rebuilds from
        the new arrays on its next use). The JAX package drops its own
        layouts here, but keeps its per-hop label masks, which no longer
        fit the arrays (ROADMAP queue 3, item 6); the port drops its
        masks too. The dense vertex columns are not cleared here."""
        self._out_csr = None
        self._out_csr_order = None
        for attr in self._DEVICE_CACHES:
            setattr(self, attr, {})

    def attach_vertex_values(self, graph, keys) -> None:
        """Build dense vertex property columns through the OLTP tx (one
        batched pass; SINGLE-cardinality keys only). Keys already
        attached are skipped; unknown keys attach as all-absent
        columns."""
        want = [k for k in keys if k not in self.vertex_values]
        if not want:
            return
        for k in want:
            st = graph.schema.get_by_name(k)
            if st is not None and \
                    graph.schema.cardinality(st.id) is not Cardinality.SINGLE:
                raise ValueError(
                    f"attach_vertex_values: key {k!r} is not "
                    "SINGLE-cardinality; multi-valued columns have no "
                    "dense representation")
        tx = graph.new_transaction(read_only=True)
        try:
            cols = {k: (np.empty(self.n, object), np.zeros(self.n, bool))
                    for k in want}
            # one multi-row property read per chunk of ids, not n point
            # reads
            chunk = 4096
            for c0 in range(0, self.n, chunk):
                ids = [int(v) for v in self.vertex_ids[c0:c0 + chunk]]
                got = tx.multi_vertex_properties(ids, keys=want)
                for j, vid in enumerate(ids):
                    props = got.get(vid)
                    if not props:
                        continue
                    for k, val in props.items():
                        if val is not None:
                            cols[k][0][c0 + j] = val
                            cols[k][1][c0 + j] = True
        finally:
            tx.rollback()
        self.vertex_values.update(cols)

    def dense_of(self, vertex_id: int) -> int:
        i = int(np.searchsorted(self.vertex_ids, vertex_id))
        if i >= self.n or self.vertex_ids[i] != vertex_id:
            raise KeyError(f"vertex {vertex_id} not in snapshot")
        return i

    def out_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """``(dst_by_src, indptr_out)``: the edges sorted by SOURCE, the
        push/expansion layout: the stable counting sort of
        ``native.csr_build`` over (dst, src), so each source's edges keep
        their dst-sorted order, as the JAX package's native path does.
        Computed once and cached with the permutation itself,
        ``_out_csr_order`` (src-order position -> dst-order row), which
        the live overlay's slot lookup reads."""
        if self._out_csr is None:
            indptr_out = np.concatenate(
                [np.zeros(1, np.int64),
                 np.cumsum(self.out_degree, dtype=np.int64)])
            order, _, _ = native.csr_build(self.dst, self.src, self.n)
            self._out_csr = (native.gather_i32(self.dst, order), indptr_out)
            self._out_csr_order = order
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
    # the stable counting sort, O(E)
    order, indptr, out_degree = native.csr_build(src, dst, n)
    src_s = native.gather_i32(src, order)
    dst_s = native.gather_i32(dst, order)
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


def _scan_python(graph, rows, exists_q, scan_q, label_ids, key_ids):
    """Per-entry decode through the Python codec: the path that extracts
    edge property values."""
    idm, schema, codec = graph.idm, graph.schema, graph.codec
    srcs: list[int] = []
    dsts: list[int] = []
    labs: list[int] = []
    ev: dict[str, list] = {name: [] for name in key_ids.values()}
    vertex_id_list: list[int] = []
    for key, entries in rows:
        vid = idm.id_of_key_bytes(key)
        if not idm.is_user_vertex_id(vid):
            continue
        # vertex-cut rows fold into the canonical vertex
        vid = idm.canonical_vertex_id(vid)
        has_exist = False
        for e in entries:
            if exists_q.contains(e.column):
                has_exist = True
            elif scan_q.contains(e.column):
                rc = codec.parse(e, schema)
                if rc.direction is not Direction.OUT or not rc.is_edge:
                    continue
                if schema.system.is_system(rc.type_id):
                    continue
                if label_ids is not None and rc.type_id not in label_ids:
                    continue
                srcs.append(vid)
                dsts.append(rc.other_vertex_id)
                labs.append(idm.count(rc.type_id))
                for kid, name in key_ids.items():
                    ev[name].append(rc.properties.get(kid, 0))
        if has_exist:
            vertex_id_list.append(vid)
    return vertex_id_list, srcs, dsts, labs, ev


def _scan_native(graph, rows, exists_q, label_ids):
    """Bulk decode through the native codec: Python only concatenates the
    column bytes; head classification and the other vertex's varint run
    as two native sweeps. Labels whose columns carry sort keys or keep
    the other vertex in the value (unique directions) take the per-entry
    parse, for those entries only."""
    idm = graph.idm

    cols = bytearray()
    offs: list[int] = [0]
    entry_row: list[int] = []
    entry_refs: list = []
    row_vids: list[int] = []
    for key, entries in rows:
        vid = idm.id_of_key_bytes(key)
        if not idm.is_user_vertex_id(vid):
            continue
        ridx = len(row_vids)
        row_vids.append(vid)
        for e in entries:
            cols += e.column
            offs.append(len(cols))
            entry_row.append(ridx)
            entry_refs.append(e)

    if not entry_refs:
        return [], np.empty(0, np.int64), np.empty(0, np.int64), [], {}

    return _native_classify(
        graph, np.frombuffer(cols, dtype=np.uint8),
        np.asarray(offs, dtype=np.int64),
        np.asarray(entry_row, dtype=np.int64),
        np.asarray(row_vids, dtype=np.int64),
        exists_q, label_ids, lambda i: entry_refs[i])


def _scan_native_packed(graph, packed_rows, exists_q, label_ids):
    """``_scan_native`` over a store's packed row scan
    (``scan_rows_packed``, ``features.packed_ops``): per-row joins and
    length maps in place of the per-entry Python loop."""
    idm = graph.idm

    chunks: list[bytes] = []
    lens: list[int] = []
    counts: list[int] = []
    row_vids: list[int] = []
    row_refs: list = []
    for key, cols_list, vals_list in packed_rows:
        vid = idm.id_of_key_bytes(key)
        if not idm.is_user_vertex_id(vid):
            continue
        row_vids.append(vid)
        chunks.append(b"".join(cols_list))
        lens.extend(map(len, cols_list))
        counts.append(len(cols_list))
        row_refs.append((cols_list, vals_list))

    if not lens:
        return [], np.empty(0, np.int64), np.empty(0, np.int64), [], {}

    col_buf = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(np.asarray(lens, np.int64), out=offs[1:])
    counts_a = np.asarray(counts, np.int64)
    entry_row = np.repeat(np.arange(len(counts_a), dtype=np.int64),
                          counts_a)
    row_start = np.zeros(len(counts_a) + 1, np.int64)
    np.cumsum(counts_a, out=row_start[1:])

    def resolve(i: int) -> Entry:
        r = int(entry_row[i])
        li = i - int(row_start[r])
        cols_list, vals_list = row_refs[r]
        return Entry(cols_list[li], vals_list[li])

    return _native_classify(graph, col_buf, offs, entry_row,
                            np.asarray(row_vids, np.int64), exists_q,
                            label_ids, resolve)


def _native_classify(graph, col_buf, offs, entry_row_a, row_vids_raw,
                     exists_q, label_ids, resolve_entry):
    """The shared tail of the native scans: classify the column heads,
    bulk-decode the other vertices, parse the rare slow labels (sort keys,
    unique directions) one entry at a time through
    ``resolve_entry(i)``."""
    idm, schema, codec = graph.idm, graph.schema, graph.codec

    kind, tcount, dpos = native.parse_heads(col_buf, offs, exists_q.start)
    # vertex-cut rows fold into the canonical vertex
    row_vids_a = idm.canonicalize_np(row_vids_raw)

    exists_rows = np.unique(entry_row_a[kind == native.KIND_EXISTS])
    vertex_id_list = row_vids_a[exists_rows]

    edge_mask = kind == native.KIND_OUT_EDGE
    keep_counts, fast_counts = [], []
    for c in np.unique(tcount[edge_mask]).tolist():
        tid = idm.schema_id(IDType.USER_EDGE_LABEL, int(c))
        if label_ids is not None and tid not in label_ids:
            continue
        keep_counts.append(c)
        if (not schema.sort_key(tid)
                and not schema.multiplicity(tid).unique(Direction.OUT)):
            fast_counts.append(c)
    keep = edge_mask & np.isin(tcount, keep_counts)
    fast = keep & np.isin(tcount, fast_counts)

    entry_ends = offs[1:]
    others, _ = native.bulk_read_uvar(col_buf, dpos[fast], entry_ends[fast])
    srcs = row_vids_a[entry_row_a[fast]]
    dsts = others
    labs = tcount[fast].astype(np.int64)

    slow_idx = np.flatnonzero(keep & ~fast)
    if len(slow_idx):
        s_src, s_dst, s_lab = [], [], []
        for i in slow_idx.tolist():
            rc = codec.parse(resolve_entry(i), schema)
            s_src.append(row_vids_a[entry_row_a[i]])
            s_dst.append(rc.other_vertex_id)
            s_lab.append(idm.count(rc.type_id))
        srcs = np.concatenate([srcs, np.asarray(s_src, np.int64)])
        dsts = np.concatenate([dsts, np.asarray(s_dst, np.int64)])
        labs = np.concatenate([labs, np.asarray(s_lab, np.int64)])
    return vertex_id_list, srcs, dsts, labs, {}


def _dense_index(vertex_ids: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """Each raw id's index in the ascending, distinct ``vertex_ids``
    where it is there, any index where it is not (the caller compares).
    Shifted right by the bits of their smallest gap, the ids stay
    distinct; where that span is at most 4n, one table gather replaces
    ``np.searchsorted``'s random binary searches, the scan's costliest
    step at scale. Otherwise ``np.searchsorted``."""
    n = len(vertex_ids)
    gap = int(np.diff(vertex_ids).min()) if n > 1 else 0
    if gap < 1:
        return np.searchsorted(vertex_ids, raw)
    shift = gap.bit_length() - 1
    lo = int(vertex_ids[0]) >> shift
    span = (int(vertex_ids[-1]) >> shift) - lo + 1
    if span > 4 * n:
        return np.searchsorted(vertex_ids, raw)
    table = np.zeros(span, np.int64)
    table[(vertex_ids >> shift) - lo] = np.arange(n, dtype=np.int64)
    key = (raw >> shift) - lo
    np.clip(key, 0, span - 1, out=key)
    return table[key]


def build(graph, labels: Optional[Sequence[str]] = None,
          edge_keys: Sequence[str] = (),
          directed: bool = True,
          _reuse_listener: Optional[tuple] = None) -> GraphSnapshot:
    """Scan the edgestore of ``graph`` (the port's ``StandardGraph``) and
    build the snapshot.

    ``labels``: restrict to these edge labels (None = every user label).
    ``edge_keys``: edge property names to extract into aligned arrays.
    ``directed=False`` adds the reverse of every edge (symmetrize).
    ``_reuse_listener``: a ``(token, ChangeQueue)`` pair to re-anchor at
    the scan-verified epoch instead of subscribing a fresh queue
    (``rebuild_in_place``).
    """
    idm = graph.idm
    schema = graph.schema
    codec = graph.codec
    label_ids = None
    if labels is not None:
        label_ids = {st.id for name in labels
                     if (st := schema.get_by_name(name)) is not None}
    key_ids = {}
    for name in edge_keys:
        st = schema.get_by_name(name)
        if st is not None:
            key_ids[st.id] = name

    lo, hi = rids.category_bounds(RelationCategory.EDGE, Direction.OUT,
                                  include_system=False)
    scan_q = SliceQuery(lo, hi)

    # Epoch discipline: capture epoch0, scan, then, under the commit
    # lock, check that the epoch did not move during the scan and
    # subscribe in the same critical section. A commit that lands
    # mid-scan may or may not be in the scanned rows, so its payload can
    # neither be applied nor skipped: scan again. Commits push their
    # payload and bump the epoch under the lock that commits storage, so
    # an unchanged epoch proves the scan saw a committed prefix.
    def _scan_once():
        btx = graph.backend.begin_transaction()
        try:
            exists_q = codec.query_type(schema.system.vertex_exists,
                                        Direction.OUT, schema)[0]
            store = graph.backend.edge_store.store
            if not key_ids:
                if getattr(graph.backend.manager.features, "packed_ops",
                           False):
                    return _scan_native_packed(
                        graph, store.scan_rows_packed(btx.store_tx),
                        exists_q, label_ids)
                return _scan_native(graph,
                                    store.get_keys(SliceQuery(),
                                                   btx.store_tx),
                                    exists_q, label_ids)
            return _scan_python(graph,
                                store.get_keys(SliceQuery(), btx.store_tx),
                                exists_q, scan_q, label_ids, key_ids)
        finally:
            btx.commit()

    def _anchor_locked():
        """Under the commit lock, with the scan verified: subscribe, or
        re-anchor the caller's queue."""
        if _reuse_listener is not None:
            tok, rq = _reuse_listener
            rq.reanchor()
            return tok, rq
        return graph._subscribe_locked()

    token = q = None
    for attempt in range(3):
        # the last attempt scans while holding the commit lock: writers
        # wait for one scan, so build() ends under any write load
        hold = graph._commit_lock if attempt == 2 else \
            contextlib.nullcontext()
        with hold:
            epoch0 = graph.mutation_epoch
            vertex_id_list, srcs, dsts, labs, ev = _scan_once()
            if attempt == 2:
                token, q = _anchor_locked()
                break
        with graph._commit_lock:
            if graph.mutation_epoch == epoch0:
                token, q = _anchor_locked()
                break
    if token is None:
        raise RuntimeError("build(): no scan was verified")

    vertex_ids = np.sort(np.asarray(vertex_id_list, dtype=np.int64))
    del vertex_id_list
    n = len(vertex_ids)
    raw_src = np.asarray(srcs, dtype=np.int64)
    raw_dst = np.asarray(dsts, dtype=np.int64)
    del srcs, dsts
    # drop edges whose endpoint is missing (ghosts)
    si = _dense_index(vertex_ids, raw_src)
    di = _dense_index(vertex_ids, raw_dst)
    si = np.clip(si, 0, max(n - 1, 0))
    di = np.clip(di, 0, max(n - 1, 0))
    ok = np.ones(len(raw_src), dtype=bool)
    if n:
        ok = (vertex_ids[si] == raw_src) & (vertex_ids[di] == raw_dst)
    del raw_src, raw_dst
    src = si[ok].astype(np.int32)
    dst = di[ok].astype(np.int32)
    del si, di
    labs_arr = np.asarray(labs, dtype=np.int32)[ok]
    evs = {name: np.array(vals)[ok] for name, vals in ev.items()}
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        labs_arr = np.concatenate([labs_arr, labs_arr])
        evs = {name: np.concatenate([v, v]) for name, v in evs.items()}
    label_names = {}
    for code in np.unique(labs_arr).tolist() if len(labs_arr) else []:
        st = schema.get_type(idm.schema_id(IDType.USER_EDGE_LABEL, code))
        if st is not None:
            label_names[code] = st.name
    snap = from_arrays(n, src, dst, vertex_ids, evs, labs_arr, label_names)
    # stamp the scan-verified epoch and attach the listener subscribed
    # with it, so that refresh() can catch up without a store scan
    snap.epoch = epoch0
    snap._graph = graph
    snap._listener_token, snap._listener = token, q
    snap._build_params = {"label_ids": label_ids, "directed": directed,
                          "labels": (tuple(labels)
                                     if labels is not None else None),
                          "edge_keys": tuple(edge_keys)}
    return snap
