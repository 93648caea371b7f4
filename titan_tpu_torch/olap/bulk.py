"""Batch-loading ingest: benchmark-scale writes through the storage plane.

The reference ships a bulk-loading mode (reference: titan-core
graphdb/configuration/GraphDatabaseConfiguration.java `storage.batch-loading`
+ docs/bulkloading.txt) that bypasses per-element consistency work so tens of
millions of elements can be loaded in reasonable time. This module is the
TPU-framework equivalent: vertex/relation ids are claimed in ONE authority
block each (the claim-column protocol, same as normal allocation — just one
big block, the reference's "increase ids.block-size for bulk loads" advice),
edge rows are encoded VECTORIZED (numpy varint sweeps instead of per-relation
DataOutput calls — the role the reference's EdgeSerializer hot loop plays,
EdgeSerializer.java:222-315), and the rows land through the ordinary KCVS
``mutate`` SPI, so everything downstream (scan, snapshot, OLAP) sees a
perfectly normal edgestore.

The port's copy of ``titan_tpu/olap/bulk.py``: the same rows, byte for
byte (tests/test_torch_bulk.py holds the edgestore to the JAX package's
after the same load, on the packed and the entry-wise path).
``ingest_rmat_store`` generates with the port's native R-MAT generator
(its library is always built; a failed build raises), and ``dist_match``
compares two BFS distance tensors with one scalar readback.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from titan_tpu_torch.codec import relation_ids as rids
from titan_tpu_torch.codec.dataio import DataOutput
from titan_tpu_torch.core.defs import Direction, Multiplicity, RelationCategory

_STOP = 0x80
_MASK = 0x7F


def _uvar_lengths(v: np.ndarray) -> np.ndarray:
    """Byte length of each value's MSB-first unsigned varint."""
    v = v.astype(np.uint64)
    n = np.ones(v.shape, np.int64)
    for k in range(1, 10):
        n += v >= np.uint64(1 << (7 * k))
    return n


def _write_uvars(out: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                 v: np.ndarray, backward: bool = False) -> None:
    """Scatter the varint bytes of ``v[i]`` at ``out[starts[i]:...+lens[i]]``.

    Forward form: MSB-first groups, stop bit on the LAST byte
    (utils/varint.write_positive). Backward form: same group order but the
    stop bit moves to the FIRST byte (write_positive_backward)."""
    v = v.astype(np.uint64)
    maxb = int(lens.max()) if len(lens) else 0
    for k in range(maxb):          # k = byte index counted from the END
        sel = lens > k
        pos = starts[sel] + (lens[sel] - 1 - k)
        b = ((v[sel] >> np.uint64(7 * k)) & np.uint64(_MASK)).astype(np.uint8)
        if not backward and k == 0:
            b |= np.uint8(_STOP)
        out[pos] = b
    if backward and maxb:
        first = lens > 0
        out[starts[first]] |= np.uint8(_STOP)


def encode_out_edge_columns(prefix: bytes, others: np.ndarray,
                            relids: np.ndarray
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized MULTI-edge OUT columns: ``prefix ⋅ uvar(other) ⋅
    uvar(relid)`` (codec/edges.py layout row 'EDGE multi', empty sort key).
    Returns (flat uint8 buffer, int64 offsets [m+1])."""
    others = np.asarray(others, np.int64)
    relids = np.asarray(relids, np.int64)
    l1 = _uvar_lengths(others)
    l2 = _uvar_lengths(relids)
    P = len(prefix)
    lens = P + l1 + l2
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    out = np.empty(int(offs[-1]), np.uint8)
    pb = np.frombuffer(prefix, np.uint8)
    for j in range(P):
        out[offs[:-1] + j] = pb[j]
    _write_uvars(out, offs[:-1] + P, l1, others)
    _write_uvars(out, offs[:-1] + P + l1, l2, relids)
    return out, offs


def encode_backward_uvars(prefix: bytes, relids: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ``prefix ⋅ backward-uvar(relid)`` buffers (the VALUE of a
    SINGLE-cardinality property row, codec/edges.py 'PROPERTY single')."""
    relids = np.asarray(relids, np.int64)
    l1 = _uvar_lengths(relids)
    P = len(prefix)
    lens = P + l1
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    out = np.empty(int(offs[-1]), np.uint8)
    pb = np.frombuffer(prefix, np.uint8)
    for j in range(P):
        out[offs[:-1] + j] = pb[j]
    _write_uvars(out, offs[:-1] + P, l1, relids, backward=True)
    return out, offs


def _claim_counts(authority, namespace: bytes, k: int,
                  chunk: int = 1 << 26) -> np.ndarray:
    """~k id counts straight from the authority (contiguous blocks)."""
    got: list[np.ndarray] = []
    have = 0
    while have < k:
        want = min(k - have, chunk)
        block = authority.get_id_block(namespace, want, 120.0)
        got.append(np.arange(block.start, block.end, dtype=np.int64))
        have += len(block)
    return np.concatenate(got)[:k]


def bulk_load_adjacency(graph, src: np.ndarray, dst: np.ndarray,
                        n: Optional[int] = None, label: str = "related",
                        partition: int = 0) -> dict:
    """Load ``n`` vertices + the directed edges (src[i] -> dst[i], dense
    [0, n) indices) through the KCVS SPI. Returns
    {"vertex_ids": int64 [n] (ascending), "n", "m", seconds...}.

    One OUT row entry per edge (the reference writes both endpoint rows;
    bulk adjacency for OLAP needs only the OUT side — snapshot.build scans
    OUT columns, snapshot.py:544). Vertex existence rows are written so
    the scan's exists filter sees every vertex, isolated-ones included.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if n is None:
        n = int(max(src.max(), dst.max())) + 1 if len(src) else 0
    m = len(src)
    t0 = time.time()

    schema, idm, codec = graph.schema, graph.idm, graph.codec
    st = schema.get_by_name(label)
    if st is None:
        st = graph.management().make_edge_label(label, Multiplicity.MULTI)
    label_id = st.id

    # --- id allocation: one authority block per namespace ---------------
    authority = graph.backend.id_authority
    from titan_tpu_torch.ids.idmanager import TYPE_BITS, IDType
    vcounts = _claim_counts(authority, b"partition%d" % partition, n)
    rcounts = _claim_counts(authority, b"relation", n + m)
    # vectorized make_id(NORMAL_VERTEX, count, partition): count in the
    # MSBs keeps id order == count order (ids/idmanager.py:124-132)
    shift = TYPE_BITS + idm.partition_bits
    vids = ((vcounts << shift) | (partition << TYPE_BITS)
            | int(IDType.NORMAL_VERTEX))
    # relation ids are bare counters (idmanager.relation_id)
    exists_relids = rcounts[:n]
    edge_relids = rcounts[n:]

    # --- encode -----------------------------------------------------------
    # row keys: key_of moves partition above count; one vectorized pack +
    # a single big-endian byte view sliced per key
    from titan_tpu_torch.ids.idmanager import TOTAL_BITS
    keys64 = ((np.int64(partition) << (TOTAL_BITS - idm.partition_bits))
              | (vcounts << TYPE_BITS) | int(IDType.NORMAL_VERTEX))
    key_bytes = keys64.astype(">i8").tobytes()

    exists_id = schema.system.vertex_exists
    exists_col = rids.type_prefix(exists_id, idm, RelationCategory.PROPERTY,
                                  Direction.OUT)
    vp = DataOutput()
    graph.serializer.write_value(vp, True)
    exists_vals, ev_offs = encode_backward_uvars(vp.getvalue(), exists_relids)

    edge_prefix = rids.type_prefix(label_id, idm, RelationCategory.EDGE,
                                   Direction.OUT)
    # group edges by source (stable): per-vertex contiguous segments
    order = np.argsort(src, kind="stable")
    src_s = src[order]
    other_vids = vids[dst[order]]
    relids_s = edge_relids[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, src_s + 1, 1)
    np.cumsum(indptr, out=indptr)
    cols_buf, col_offs = encode_out_edge_columns(edge_prefix, other_vids,
                                                 relids_s)
    cols_bytes = cols_buf.tobytes()
    ev_bytes = exists_vals.tobytes()
    encode_s = time.time() - t0

    # --- mutate through the SPI ------------------------------------------
    t1 = time.time()
    from titan_tpu_torch.storage.api import Entry
    store = graph.backend.edge_store.store
    txh = graph.backend.manager.begin_transaction()
    empty_val = b"\x80"          # uvar(0): zero non-sort-key properties
    packed = getattr(graph.backend.manager.features, "packed_ops", False)
    P = len(edge_prefix)
    if packed:
        starts = col_offs[:-1]
        lens = np.diff(col_offs)
        K = int(lens.max() - P) if m else 0
    if packed and K <= 16:
        # the packed path slots the exists column before/after ALL edge
        # columns by one byte-compare — only sound while category codes
        # are prefix-free AND differ in their first byte (a codec change
        # that shares the leading byte would interleave edge columns
        # around the exists column, and mutate_row_packed adopts rows
        # verbatim, silently breaking sliced reads)
        if exists_col[:1] == edge_prefix[:1]:
            raise AssertionError(
                "packed bulk path: vertex-exists and edge category "
                "prefixes share their first byte "
                f"({exists_col[:1]!r}) — within-row byte order is no "
                "longer decided by the category slot; fix the codec "
                "prefixes or disable features.packed_ops")
        # packed bulk path: rows are adopted whole, so columns must
        # arrive byte-sorted. All edge columns share the category
        # prefix, so the within-row order is decided by the <=16
        # post-prefix bytes — two big-endian u64 sort keys accumulated
        # byte-at-a-time with 1-D gathers (a padded [m, K] byte matrix
        # would transiently cost ~11GB of host RAM at the bench's
        # scale-22 target), then one stable lexsort groups by row and
        # orders within it. The exists column's category prefix
        # differs in its FIRST byte (prefixed-varint encodings are
        # prefix-free per category), so its slot is UNIFORM per row.
        key_hi = np.zeros(m, np.uint64)
        key_lo = np.zeros(m, np.uint64)
        base = starts + P
        limit = max(len(cols_buf) - 1, 0)
        for j in range(K):
            b = cols_buf[np.minimum(base + j, limit)].astype(np.uint64)
            b = np.where(P + j < lens, b, 0)
            if j < 8:
                key_hi = (key_hi << np.uint64(8)) | b
            else:
                key_lo = (key_lo << np.uint64(8)) | b
        order2 = np.lexsort((key_lo, key_hi, src_s))
        sstart_a = starts[order2]
        slen_a = lens[order2]
        del key_hi, key_lo, order2
        exists_first = exists_col < edge_prefix
        ev_o = ev_offs.tolist()
        ip = indptr.tolist()
        mrp = store.mutate_row_packed
        for i in range(n):
            ex_val = ev_bytes[ev_o[i]:ev_o[i + 1]]
            e0, e1 = ip[i], ip[i + 1]
            # per-row tolist keeps peak memory at row scale (a global
            # 67M-int tolist holds ~2.5GB of boxed ints per array)
            ecols = [cols_bytes[s:s + l] for s, l in
                     zip(sstart_a[e0:e1].tolist(),
                         slen_a[e0:e1].tolist())]
            evals = [empty_val] * (e1 - e0)
            if exists_first:
                cols_l = [exists_col] + ecols
                vals_l = [ex_val] + evals
            else:
                cols_l = ecols + [exists_col]
                vals_l = evals + [ex_val]
            mrp(key_bytes[8 * i:8 * i + 8], cols_l, vals_l, txh)
    else:
        for i in range(n):
            adds = [Entry(exists_col,
                          ev_bytes[ev_offs[i]:ev_offs[i + 1]])]
            e0, e1 = indptr[i], indptr[i + 1]
            if e1 > e0:
                o = col_offs[e0:e1 + 1]
                adds.extend(Entry(cols_bytes[o[j]:o[j + 1]], empty_val)
                            for j in range(e1 - e0))
            store.mutate(key_bytes[8 * i:8 * i + 8], adds, [], txh)
    txh.commit()
    mutate_s = time.time() - t1
    return {"vertex_ids": vids, "n": n, "m": m,
            "encode_s": encode_s, "mutate_s": mutate_s,
            "ingest_s": time.time() - t0}


def ingest_rmat_store(scale: int, edge_factor: int = 16, seed: int = 2,
                      backend: str = "inmemory",
                      directory: Optional[str] = None) -> dict:
    """Bench-stage helper: generate an R-MAT edge list, bulk-load it into a
    fresh graph's edgestore, scan it back into a symmetrized snapshot.
    Returns {"graph", "snapshot", "n", "m", "ingest_s", "scan_s",
    "vertex_ids"} (``vertex_ids``: the bulk loader's, ascending)."""
    import titan_tpu_torch
    from titan_tpu_torch import native
    from titan_tpu_torch.olap import snapshot as snap_mod

    n = 1 << scale
    m = n * edge_factor
    src, dst = native.rmat_gen(m, scale, seed=seed)

    conf = {"storage.backend": backend}
    if directory:
        conf["storage.directory"] = directory
    g = titan_tpu_torch.open(conf)
    res = bulk_load_adjacency(g, src, dst, n=n)
    del src, dst
    t0 = time.time()
    # directed=False symmetrizes the scanned OUT rows: BFS distances then
    # match the generated graph's chunked CSR exactly (duplicate edges and
    # self-loops do not move BFS levels)
    snap = snap_mod.build(g, directed=False)
    scan_s = time.time() - t0
    return {"graph": g, "snapshot": snap, "n": res["n"], "m": res["m"],
            "ingest_s": res["ingest_s"], "scan_s": scan_s,
            "vertex_ids": res["vertex_ids"]}


def dist_match(dist_a: torch.Tensor, dist_b: torch.Tensor, inf: int) -> bool:
    """BFS-distance equality on the tensors' device, with one scalar
    readback (a scale-22 dist array read back costs far more). Unreached
    stays unreached: values >= inf compare as inf."""
    if dist_a.shape != dist_b.shape:
        return False
    a = torch.clamp(dist_a, max=inf)
    b = torch.clamp(dist_b, max=inf)
    return int((a != b).sum().item()) == 0
