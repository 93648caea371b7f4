"""The port's bulk loader (titan_tpu_torch/olap/bulk.py) and its native
codec against the JAX package's: the same loads write byte-equal
edgestore rows on the packed and the entry-wise path, ingest_rmat_store
scans back the same snapshot, and parse_heads/bulk_read_uvar decode the
same buffers to the same arrays (their errors included). dist_match runs
on CPU tensors."""

import dataclasses

import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu_torch
from titan_tpu import native as JN
from titan_tpu.olap import bulk as JB
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu.storage.inmemory import InMemoryStoreManager as JMgr
from titan_tpu_torch import native as PN
from titan_tpu_torch.device import INF
from titan_tpu_torch.models.bfs_hybrid import frontier_bfs_hybrid
from titan_tpu_torch.olap import bulk as PB
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.storage.inmemory import InMemoryStoreManager as PMgr

FIELDS = ("n", "vertex_ids", "src", "dst", "indptr_in", "out_degree",
          "labels", "label_names", "epoch")


def rows(g) -> list:
    store = g.backend.edge_store.store
    return [(k, list(c), list(v)) for k, c, v in
            store.scan_rows_packed(None)]


def same_snapshot(ps, js) -> None:
    for f in FIELDS:
        a, b = getattr(ps, f), getattr(js, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


def unpacked(monkeypatch) -> None:
    """Both in-memory stores without packed ops: the entry-wise load and
    the entry-wise native scan."""
    for mgr in (JMgr, PMgr):
        feats = mgr.features.fget

        def no_packed(self, feats=feats):
            return dataclasses.replace(feats(self), packed_ops=False)
        monkeypatch.setattr(mgr, "features", property(no_packed))


def rmat(scale: int, ef: int, seed: int = 2):
    return PN.rmat_gen((1 << scale) * ef, scale, seed=seed)


def test_the_generators_agree():
    for scale in (8, 11):
        ps, pd = rmat(scale, 8, seed=5)
        js, jd = JN.rmat_gen((1 << scale) * 8, scale, seed=5)
        assert np.array_equal(ps, js) and np.array_equal(pd, jd)


def test_column_encoders_are_byte_equal():
    rng = np.random.default_rng(3)
    others = rng.integers(1, 1 << 40, size=700, dtype=np.int64)
    relids = rng.integers(1, 1 << 30, size=700, dtype=np.int64)
    for prefix in (b"\x17\x02", b"\x41"):
        a = PB.encode_out_edge_columns(prefix, others, relids)
        b = JB.encode_out_edge_columns(prefix, others, relids)
        assert a[0].tobytes() == b[0].tobytes()
        assert np.array_equal(a[1], b[1])
        a = PB.encode_backward_uvars(prefix, relids)
        b = JB.encode_backward_uvars(prefix, relids)
        assert a[0].tobytes() == b[0].tobytes()
        assert np.array_equal(a[1], b[1])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "mutate"])
@pytest.mark.parametrize("scale", [8, 10, 12])
def test_bulk_load_rows_are_byte_equal(scale, packed, monkeypatch):
    if not packed:
        unpacked(monkeypatch)
    src, dst = rmat(scale, 8, seed=scale)
    n = 1 << scale
    gj, gp = titan_tpu.open("inmemory"), titan_tpu_torch.open("inmemory")
    try:
        assert gp.backend.manager.features.packed_ops is packed
        rj = JB.bulk_load_adjacency(gj, src, dst, n=n, label="L")
        rp = PB.bulk_load_adjacency(gp, src, dst, n=n, label="L")
        assert np.array_equal(rp["vertex_ids"], rj["vertex_ids"])
        assert (rp["n"], rp["m"]) == (rj["n"], rj["m"]) == (n, len(src))
        assert rows(gp) == rows(gj)
        for directed in (True, False):
            same_snapshot(PS.build(gp, directed=directed),
                          JS.build(gj, directed=directed))
    finally:
        gj.close()
        gp.close()


@pytest.mark.parametrize("scale", [8, 12])
def test_ingest_rmat_store_matches_the_jax_ingest(scale):
    rp = PB.ingest_rmat_store(scale, edge_factor=8, seed=2)
    rj = JB.ingest_rmat_store(scale, edge_factor=8, seed=2)
    try:
        assert (rp["n"], rp["m"]) == (rj["n"], rj["m"])
        assert rows(rp["graph"]) == rows(rj["graph"])
        same_snapshot(rp["snapshot"], rj["snapshot"])
        assert np.array_equal(rp["vertex_ids"], rp["snapshot"].vertex_ids)
        # the store keeps duplicates and self-loops: the edge multiset
        # is the generated list plus its reverse
        src, dst = rmat(scale, 8)
        snap, n = rp["snapshot"], rp["n"]
        want = np.sort(np.concatenate([src.astype(np.int64) * n + dst,
                                       dst.astype(np.int64) * n + src]))
        got = np.sort(snap.src.astype(np.int64) * n + snap.dst)
        assert np.array_equal(got, want)
    finally:
        rp["graph"].close()
        rj["graph"].close()


def test_store_bfs_matches_the_generated_graph():
    """bench.py's store_ingest check at s10: the BFS over the store's
    snapshot equals the BFS over the generated edge list, compared with
    dist_match."""
    res = PB.ingest_rmat_store(10, edge_factor=8, seed=2)
    try:
        src, dst = rmat(10, 8)
        n = 1 << 10
        ref = PS.from_arrays(n, np.concatenate([src, dst]),
                             np.concatenate([dst, src]))
        rng = np.random.default_rng(12345)
        source = int(rng.choice(np.flatnonzero(ref.out_degree > 0), size=1,
                                replace=False)[0])
        d1, _ = frontier_bfs_hybrid(res["snapshot"], source,
                                    return_device=True, device="cpu")
        d2, _ = frontier_bfs_hybrid(ref, source, return_device=True,
                                    device="cpu")
        assert PB.dist_match(d1, d2, int(INF))
        assert int((d1 < INF).sum()) > n // 2
    finally:
        res["graph"].close()


def test_dist_match_on_cpu_tensors():
    a = torch.tensor([0, 1, 2, INF, INF + 5], dtype=torch.int32)
    assert PB.dist_match(a, a.clone(), int(INF))
    b = a.clone()
    b[4] = INF                         # unreached stays unreached
    assert PB.dist_match(a, b, int(INF))
    b[1] = 2
    assert not PB.dist_match(a, b, int(INF))
    assert not PB.dist_match(a, a[:4], int(INF))


def test_packed_path_refuses_a_shared_category_prefix_byte(monkeypatch):
    real = PB.rids.type_prefix

    def shared_first_byte(type_id, idm, category, direction):
        return b"\x7f" + real(type_id, idm, category, direction)[1:]

    monkeypatch.setattr(PB.rids, "type_prefix", shared_first_byte)
    g = titan_tpu_torch.open("inmemory")
    try:
        src = np.arange(8)
        with pytest.raises(AssertionError, match="share their first byte"):
            PB.bulk_load_adjacency(g, src, (src + 1) % 8, n=8)
    finally:
        g.close()


@pytest.fixture(scope="module")
def column_buffer():
    """The concatenated columns of a bulk-loaded store and the exists
    column's prefix, as the packed scan hands them to parse_heads."""
    g = titan_tpu_torch.open("inmemory")
    try:
        src, dst = rmat(9, 8, seed=4)
        PB.bulk_load_adjacency(g, src, dst, n=1 << 9)
        cols = [c for _, cs, _ in
                g.backend.edge_store.store.scan_rows_packed(None)
                for c in cs]
        exists = g.codec.query_type(g.schema.system.vertex_exists,
                                    PS.Direction.OUT, g.schema)[0].start
    finally:
        g.close()
    offs = np.zeros(len(cols) + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=offs[1:])
    return np.frombuffer(b"".join(cols), np.uint8), offs, exists


def test_parse_heads_and_bulk_read_uvar_equal_the_jax_codec(column_buffer):
    buf, offs, exists = column_buffer
    for prefix in (exists, b""):
        got = PN.parse_heads(buf, offs, prefix)
        want = JN.parse_heads(buf, offs, prefix)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    kind, _, dpos = PN.parse_heads(buf, offs, exists)
    assert (kind == PN.KIND_EXISTS).sum() == 1 << 9
    assert (PN.KIND_SKIP, PN.KIND_OUT_EDGE, PN.KIND_EXISTS) == \
        (JN.KIND_SKIP, JN.KIND_OUT_EDGE, JN.KIND_EXISTS)
    edge = kind == PN.KIND_OUT_EDGE
    for bounds in (offs[1:][edge], None):
        got = PN.bulk_read_uvar(buf, dpos[edge], bounds)
        want = JN.bulk_read_uvar(buf, dpos[edge], bounds)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_the_codec_errors_equal_the_jax_codec(column_buffer):
    buf, offs, exists = column_buffer
    # an unterminated varint: its bound cuts it before the stop bit
    data = np.frombuffer(bytes([0x81, 0x05, 0x83, 0x7f, 0x00]), np.uint8)
    for M in (PN, JN):
        with pytest.raises(ValueError, match="corrupt varint at entry 2"):
            M.bulk_read_uvar(data, np.array([0, 1, 3]))
        with pytest.raises(ValueError, match="corrupt varint at entry 1"):
            M.bulk_read_uvar(data, np.array([0, 1]), np.array([1, 2]))
    # a column head whose varint runs past its entry
    bad = buf.copy()
    first_edge = int(np.flatnonzero(
        PN.parse_heads(buf, offs, exists)[0] == PN.KIND_OUT_EDGE)[0])
    lo = int(offs[first_edge])
    bad[lo] |= 0x10                   # set the head's continue bit
    bad[lo + 1:int(offs[first_edge + 1])] = 0x01     # never stops
    msgs = []
    for M in (PN, JN):
        with pytest.raises(ValueError, match="corrupt column head") as e:
            M.parse_heads(bad, offs, exists)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_the_library_abi_is_checked():
    assert PN.library().tt_abi_version() == PN.ABI_VERSION == 2
