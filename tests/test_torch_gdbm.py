"""The port's gdbm store (titan_tpu_torch.storage.gdbmkv) against the JAX
package's, on twin graphs and at the KCVS layer: the same seeded
operations give the same edgestore rows as the JAX package's gdbm graph
and as the port's in-memory twin, the gdbm records are byte-equal to the
JAX package's (``_encode_row``; the files themselves are in hash order),
and the KCVS contract cases of tests/test_kcvs_contract.py that run on
gdbm pass on the port's. The port reaches GNU dbm through its ctypes
binding of libgdbm (``LibGdbm``); ``dbm.gnu`` reads its files here as
the independent check that they are GNU dbm's."""

import dbm.gnu as gdbm
import os
import random

import numpy as np
import pytest

import titan_tpu
import titan_tpu_torch
from titan_tpu.ids.placement import SimpleBulkPlacement as JPlace
from titan_tpu.storage import gdbmkv as JG
from titan_tpu_torch.ids.placement import SimpleBulkPlacement as PPlace
from titan_tpu_torch.storage import (Entry, KCVMutation, KeyRangeQuery,
                                     KeySliceQuery, SliceQuery)
from titan_tpu_torch.storage import gdbmkv as PG
from titan_tpu_torch.storage.registry import store_manager

PKGS = {"jax": (titan_tpu, JPlace), "port": (titan_tpu_torch, PPlace)}
#: commits that do not sleep out the claim waits
FAST = {"storage.lock.wait-time": 5, "ids.authority.wait-time": 5}


def gdbm_config(directory) -> dict:
    return {"storage.backend": "gdbm", "storage.directory": str(directory),
            **FAST}


def open_twin(which, config):
    pkg, place = PKGS[which]
    g = pkg.open({**config, **FAST})
    g.id_assigner.placement = place(g.idm.num_partitions, batch_size=5,
                                    seed=11)
    return g


def run_ops(g, seed: int = 3) -> list:
    """Seeded commits: vertices, edges, then removals and an update."""
    rng = np.random.default_rng(seed)
    tx = g.new_transaction()
    vs = [tx.add_vertex("person" if i % 3 else "place", name=f"v{i}",
                        age=int(rng.integers(0, 90))) for i in range(30)]
    for _ in range(80):
        a, b = (int(x) for x in rng.integers(0, len(vs), 2))
        vs[a].add_edge("knows", vs[b], since=a * b)
    tx.commit()
    vids = [v.id for v in vs]
    tx = g.new_transaction()
    for k in rng.choice(len(vids), 5, replace=False):
        for e in list(tx.vertex(vids[int(k)]).out_edges("knows"))[:1]:
            e.remove()
    tx.vertex(vids[4]).remove()
    tx.vertex(vids[9]).property("age", 1)
    tx.commit()
    return vids


def rows(g, name="edgestore") -> list:
    store = g.backend.manager.open_database(name)
    return [(k, list(c), list(v)) for k, c, v in
            store.scan_rows_packed(None)]


def raw_records(path) -> dict:
    """Every record of a gdbm file, by key."""
    db = gdbm.open(path, "r")
    try:
        out, k = {}, db.firstkey()
        while k is not None:
            out[k] = db[k]
            k = db.nextkey(k)
        return out
    finally:
        db.close()


@pytest.fixture
def twins(tmp_path):
    out = {}
    for which in PKGS:
        g = open_twin(which, gdbm_config(tmp_path / which))
        out[which] = (g, run_ops(g))
    out["mem"] = (open_twin("port", {"storage.backend": "inmemory"}), None)
    run_ops(out["mem"][0])
    yield out, tmp_path
    for g, _ in out.values():
        if g.is_open:
            g.close()


def test_twin_rows_equal_jax_gdbm_and_the_inmemory_twin(twins):
    out, _ = twins
    (gj, vj), (gp, vp), (gm, _) = out["jax"], out["port"], out["mem"]
    assert vp == vj
    assert len(rows(gp)) > 29
    assert rows(gp) == rows(gj) == rows(gm)
    assert rows(gp, "graphindex") == rows(gm, "graphindex")


def test_records_are_byte_equal_to_jax(twins):
    out, tmp = twins
    for which in ("jax", "port"):
        out[which][0].close()
    for name in ("edgestore", "graphindex"):
        want = raw_records(str(tmp / "jax" / f"{name}.gdbm"))
        got = raw_records(str(tmp / "port" / f"{name}.gdbm"))
        assert got == want and got, name


def test_reopen_reads_the_records_back(twins):
    out, tmp = twins
    gp, vids = out["port"]
    want = rows(gp)
    gp.close()
    g2 = titan_tpu_torch.open(gdbm_config(tmp / "port"))
    try:
        assert rows(g2) == want
        assert g2.traversal().V().count().next() == len(vids) - 1
        tx = g2.new_transaction()
        assert tx.vertex(vids[9]).value("age") == 1
        tx.rollback()
    finally:
        g2.close()


def test_a_jax_written_directory_opens_in_the_port(twins):
    out, tmp = twins
    gj, vids = out["jax"]
    want = rows(gj)
    gj.close()
    g2 = titan_tpu_torch.open(gdbm_config(tmp / "jax"))
    try:
        assert rows(g2) == want
        names = sorted(v.value("name") for v in
                       g2.traversal().V().has("age", 1).to_list())
        assert names == ["v9"]
    finally:
        g2.close()


@pytest.mark.parametrize("cols", [
    [], [(b"a", b"")], [(b"\x00", b"\xff" * 3), (b"zz", b"v")],
    [(bytes([i]), bytes(range(i))) for i in range(40)]])
def test_encode_row_is_the_jax_encoding(cols):
    assert PG._encode_row(cols) == JG._encode_row(cols)
    assert PG._decode_row(JG._encode_row(cols)) == cols


def test_registry_and_graph_suite_on_gdbm(tmp_path):
    """tests/test_kcvs_contract.py's TestGdbmGraphSuite on the port."""
    d = str(tmp_path / "gd")
    assert isinstance(store_manager("gdbm", directory=d),
                      PG.GdbmStoreManager)
    with pytest.raises(ValueError, match="storage.directory"):
        store_manager("gdbm")
    g = titan_tpu_torch.open(gdbm_config(d))
    tx = g.new_transaction()
    vs = [tx.add_vertex("person", name=f"p{i}") for i in range(20)]
    for i in range(19):
        vs[i].add_edge("knows", vs[i + 1])
    tx.commit()
    assert g.traversal().V().count().next() == 20
    assert g.traversal().V().out("knows").count().next() == 19
    assert g.traversal().V(vs[0].id).out("knows").out("knows") \
        .count().next() == 1
    g.close()
    g2 = titan_tpu_torch.open(gdbm_config(d))
    try:
        assert g2.traversal().V().count().next() == 20
        assert {v.value("name") for v in g2.traversal().V().to_list()} \
            == {f"p{i}" for i in range(20)}
    finally:
        g2.close()


def test_snapshot_and_compute_on_gdbm(tmp_path):
    from titan_tpu_torch.models import bfs as MB
    from titan_tpu_torch.olap import snapshot as PS

    g = titan_tpu_torch.open(gdbm_config(tmp_path / "gd2"))
    try:
        tx = g.new_transaction()
        vs = [tx.add_vertex("n") for _ in range(10)]
        for i in range(9):
            vs[i].add_edge("link", vs[i + 1])
        tx.commit()
        snap = PS.build(g)
        assert snap.n == 10 and snap.num_edges == 9
        comp = g.compute(device="cpu")
        res = MB.run(comp, vs[0].id, snapshot=PS.build(g, directed=False))
        assert sorted(np.asarray(res["dist"]).tolist()) == list(range(10))
    finally:
        g.close()


# ---- tests/test_kcvs_contract.py, on the port's gdbm store

@pytest.fixture
def manager(tmp_path):
    m = PG.GdbmStoreManager(str(tmp_path / "gdbm"))
    yield m
    m.close()


def k(i: int) -> bytes:
    return i.to_bytes(8, "big")


def c(i: int) -> bytes:
    return i.to_bytes(4, "big")


def test_roundtrip_and_slice_semantics(manager):
    store = manager.open_database("edgestore")
    t = manager.begin_transaction()
    store.mutate(k(1), [Entry(c(j), b"v%d" % j) for j in range(10)], [], t)
    t.commit()
    t = manager.begin_transaction()
    full = store.get_slice(KeySliceQuery(k(1), SliceQuery()), t)
    assert [e.column for e in full] == [c(j) for j in range(10)]
    part = store.get_slice(KeySliceQuery(k(1), SliceQuery(c(3), c(7))), t)
    assert [e.column for e in part] == [c(3), c(4), c(5), c(6)]
    lim = store.get_slice(KeySliceQuery(k(1), SliceQuery(c(3), c(7),
                                                         limit=2)), t)
    assert [e.column for e in lim] == [c(3), c(4)]
    edge = store.get_slice(KeySliceQuery(k(1), SliceQuery(c(9), None)), t)
    assert [e.column for e in edge] == [c(9)]
    assert store.get_slice(KeySliceQuery(k(99), SliceQuery()), t) == []
    t.commit()


def test_overwrite_and_delete(manager):
    store = manager.open_database("edgestore")
    t = manager.begin_transaction()
    store.mutate(k(5), [Entry(c(1), b"a"), Entry(c(2), b"b")], [], t)
    store.mutate(k(5), [Entry(c(1), b"a2")], [c(2)], t)
    t.commit()
    t = manager.begin_transaction()
    assert store.get_slice(KeySliceQuery(k(5), SliceQuery()), t) == \
        [Entry(c(1), b"a2")]


def test_multi_key_slice(manager):
    store = manager.open_database("edgestore")
    t = manager.begin_transaction()
    for i in range(20):
        store.mutate(k(i), [Entry(c(j), b"x") for j in range(5)], [], t)
    keys = [k(i) for i in (3, 7, 11, 99)]
    result = store.get_slice_multi(keys, SliceQuery(c(1), c(4)), t)
    assert set(result) == set(keys)
    assert [e.column for e in result[k(3)]] == [c(1), c(2), c(3)]
    assert result[k(99)] == []


def test_ordered_key_scan(manager):
    store = manager.open_database("edgestore")
    t = manager.begin_transaction()
    ids = random.Random(1).sample(range(1000), 50)
    for i in ids:
        store.mutate(k(i), [Entry(c(0), b"v")], [], t)
    seen = [key for key, _ in store.get_keys(
        KeyRangeQuery(k(0), k(1000), SliceQuery()), t)]
    assert seen == sorted(k(i) for i in ids)
    lo, hi = k(200), k(700)
    sub = [key for key, _ in store.get_keys(
        KeyRangeQuery(lo, hi, SliceQuery()), t)]
    assert sub == [key for key in seen if lo <= key < hi]


def test_unordered_scan_sees_all(manager):
    store = manager.open_database("edgestore")
    t = manager.begin_transaction()
    for i in range(30):
        store.mutate(k(i), [Entry(c(i % 3), b"v")], [], t)
    assert len(dict(store.get_keys(SliceQuery(), t))) == 30
    assert len(dict(store.get_keys(SliceQuery(c(1), c(3)), t))) == 20


def test_mutate_many_batch_and_row_deletion(manager):
    t = manager.begin_transaction()
    manager.mutate_many({
        "edgestore": {k(1): KCVMutation([Entry(c(1), b"a")], []),
                      k(2): KCVMutation([Entry(c(2), b"b")], [])},
        "graphindex": {k(3): KCVMutation([Entry(c(3), b"c")], [])}}, t)
    t.commit()
    t = manager.begin_transaction()
    assert manager.open_database("graphindex").get_slice(
        KeySliceQuery(k(3), SliceQuery()), t) == [Entry(c(3), b"c")]
    store = manager.open_database("edgestore")
    store.mutate(k(1), [], [c(1)], t)
    assert [key for key, _ in store.get_keys(
        KeyRangeQuery(k(0), k(100), SliceQuery()), t)] == [k(2)]


def test_clear_storage_features_and_packed_ops(manager):
    f = manager.features
    assert f.ordered_scan and f.unordered_scan and f.key_ordered
    store = manager.open_database("edgestore")
    t = manager.begin_transaction()
    store.mutate_row_packed(k(1), [c(i) for i in range(6)],
                            [b"v%d" % i for i in range(6)], t)
    store.mutate(k(2), [Entry(c(9), b"w")], [], t)
    packed = [(key, list(cs), list(vs)) for key, cs, vs in
              store.scan_rows_packed(None)]
    assert packed == [(k(1), [c(i) for i in range(6)],
                       [b"v%d" % i for i in range(6)]),
                      (k(2), [c(9)], [b"w"])]
    assert manager.exists()
    manager.clear_storage()
    assert not manager.exists()
    store = manager.open_database("edgestore")
    assert store.get_slice(KeySliceQuery(k(1), SliceQuery()), t) == []
    with pytest.raises(NotImplementedError, match="no native locking"):
        store.acquire_lock(k(1), c(1), None, t)


def test_the_port_store_writes_what_the_jax_store_reads(tmp_path):
    """Manager level, both directions: each package's store opened over
    the other's directory reads its rows."""
    for writer, reader in ((PG, JG), (JG, PG)):
        d = str(tmp_path / writer.__name__.split(".")[0])
        m = writer.GdbmStoreManager(d)
        store = m.open_database("edgestore")
        t = m.begin_transaction()
        for i in (5, 1, 3):
            store.mutate(k(i), [Entry(c(i), b"x" * i)], [], t)
        t.commit()
        m.close()
        m2 = reader.GdbmStoreManager(d)
        got = [(key, [(e.column, e.value) for e in es]) for key, es in
               m2.open_database("edgestore").get_keys(
                   SliceQuery(), m2.begin_transaction())]
        assert got == [(k(i), [(c(i), b"x" * i)]) for i in (1, 3, 5)]
        m2.close()
        assert os.listdir(d) == ["edgestore.gdbm"]


def test_libgdbm_and_dbm_gnu_read_each_others_files(tmp_path):
    path = str(tmp_path / "x.gdbm")
    db = PG.open_gdbm(path)
    assert isinstance(db, PG.LibGdbm)
    db[b"k"] = b"\x00v"
    db[b"e"] = b""
    assert db.get(b"k") == b"\x00v" and db.get(b"nope") is None
    assert b"e" in db and b"nope" not in db
    with pytest.raises(KeyError):
        del db[b"nope"]
    db.close()
    assert raw_records(path) == {b"k": b"\x00v", b"e": b""}
    with gdbm.open(path, "w") as raw:
        raw[b"g"] = b"\xffw"
        del raw[b"e"]
    db = PG.open_gdbm(path)
    keys, key = set(), db.firstkey()
    while key is not None:
        keys.add(key)
        key = db.nextkey(key)
    assert keys == {b"k", b"g"} and db.get(b"g") == b"\xffw"
    db.close()
