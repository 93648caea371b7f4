"""The port's sqlite store (titan_tpu_torch/storage/sqlitekv.py), its
write-ahead log (core/wal.py) and its change-log processors
(core/changes.LogProcessorFramework, ``titan_tpu_torch.open_log_processors``)
held to the JAX package's: twin graphs (the same seeded operations,
``SimpleBulkPlacement`` seeded in both) give byte-equal sqlite rows; a
store directory closes and reopens; two handles share one directory; the
WAL writes the same records and recovery replays lost index writes
(tests/test_coordination.py's WAL tests, mirrored); the processors see the
same change states, isolated per message and per processor."""

import sqlite3
import time

import numpy as np
import pytest

import titan_tpu
import titan_tpu_torch
from titan_tpu.core import wal as JW
from titan_tpu.core.defs import Cardinality as JCard
from titan_tpu.ids.placement import SimpleBulkPlacement as JPlace
from titan_tpu_torch.core import wal as PW
from titan_tpu_torch.core.changes import (USER_LOG_PREFIX,
                                          LogProcessorFramework)
from titan_tpu_torch.core.defs import Cardinality as PCard
from titan_tpu_torch.ids.placement import SimpleBulkPlacement as PPlace
from titan_tpu_torch.storage.api import Entry, KeySliceQuery, SliceQuery
from titan_tpu_torch.storage.log import ReadMarker
from titan_tpu_torch.storage.sqlitekv import SqliteStoreManager

PKGS = {"jax": (titan_tpu, JPlace, JCard, JW),
        "port": (titan_tpu_torch, PPlace, PCard, PW)}
#: stores whose rows carry no instance id or timestamp
DATA_STORES = ("edgestore", "graphindex")


def _open(which, config, seed=None):
    pkg, place, _, _ = PKGS[which]
    g = pkg.open(config)
    if seed is not None:
        g.id_assigner.placement = place(g.idm.num_partitions,
                                        batch_size=5, seed=seed)
    return g


def _sqlite(directory, instance="a"):
    return {"storage.backend": "sqlite", "storage.directory": directory,
            "graph.unique-instance-id": instance}


def _wait_for(pred, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def run_ops(g, which: str, seed: int) -> list:
    """A seeded sequence: schema with a composite index, vertices with
    properties, edges, then removals and a property change. Returns the
    vertex ids."""
    card = PKGS[which][2]
    m = g.management()
    m.make_property_key("name", str, card.SINGLE)
    m.make_property_key("age", int, card.SINGLE)
    m.build_index("by_name").add_key("name").build_composite_index()
    m.commit()
    rng = np.random.default_rng(seed)
    tx = g.new_transaction()
    vs = [tx.add_vertex("node", name=f"v{i}", age=int(rng.integers(90)))
          for i in range(16)]
    for _ in range(40):
        a, b = (int(x) for x in rng.integers(0, len(vs), 2))
        vs[a].add_edge("knows" if a % 2 else "likes", vs[b])
    tx.commit()
    vids = [v.id for v in vs]
    tx = g.new_transaction()
    for k in rng.choice(len(vids), 3, replace=False):
        for e in list(tx.vertex(vids[int(k)]).out_edges())[:1]:
            e.remove()
    tx.vertex(vids[4]).remove()
    tx.vertex(vids[5]).property("age", 7)
    tx.commit()
    return vids


def table_rows(directory, store: str) -> list:
    conn = sqlite3.connect(f"{directory}/titan_tpu.db")
    try:
        return conn.execute(f"SELECT k, c, v, e FROM kcvs_{store} "
                            "ORDER BY k, c").fetchall()
    finally:
        conn.close()


def tables(directory) -> set:
    conn = sqlite3.connect(f"{directory}/titan_tpu.db")
    try:
        return {r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table'")}
    finally:
        conn.close()


@pytest.mark.parametrize("seed", [1, 2])
def test_sqlite_rows_are_byte_equal_to_jax(tmp_path, seed):
    dirs, vids = {}, {}
    for which in PKGS:
        dirs[which] = str(tmp_path / which)
        g = _open(which, _sqlite(dirs[which]), seed=seed)
        vids[which] = run_ops(g, which, seed)
        g.close()
    assert vids["port"] == vids["jax"]
    assert tables(dirs["port"]) == tables(dirs["jax"])
    for store in DATA_STORES:
        rows = table_rows(dirs["port"], store)
        assert len(rows) > 16
        assert rows == table_rows(dirs["jax"], store), store
    # the other stores hold the instance id and timestamps: their row
    # counts agree
    for t in tables(dirs["port"]):
        store = t[len("kcvs_"):]
        if store not in DATA_STORES:
            assert len(table_rows(dirs["port"], store)) == \
                len(table_rows(dirs["jax"], store)), store


def test_close_and_reopen_a_store_directory(tmp_path):
    d = str(tmp_path / "db")
    g = _open("port", _sqlite(d), seed=3)
    vids = run_ops(g, "port", 3)
    before = table_rows(d, "edgestore")
    g.close()
    g = titan_tpu_torch.open(_sqlite(d))
    try:
        tx = g.new_transaction()
        got = sorted(v.id for v in tx.vertices())
        assert got == sorted(v for i, v in enumerate(vids) if i != 4)
        assert tx.vertex(vids[5]).value("age") == 7
        assert tx.vertex(vids[6]).value("name") == "v6"
        tx.rollback()
        tx = g.new_transaction()
        tx.add_vertex("node", name="after")
        tx.commit()
    finally:
        g.close()
    after = table_rows(d, "edgestore")
    assert len(after) > len(before)
    assert set(before) <= set(after)
    assert SqliteStoreManager(d).exists()


def test_two_handles_share_one_directory(tmp_path):
    d = str(tmp_path / "db")
    g1 = titan_tpu_torch.open(_sqlite(d, "a"))
    g2 = titan_tpu_torch.open(_sqlite(d, "b"))
    try:
        assert g1.instance_id != g2.instance_id
        tx = g1.new_transaction()
        a, b = tx.add_vertex("node", name="a"), tx.add_vertex("node",
                                                               name="b")
        tx.commit()
        tx = g2.new_transaction()
        tx.vertex(a.id).add_edge("link", tx.vertex(b.id))
        c = tx.add_vertex("node", name="c")
        tx.commit()
        assert c.id not in (a.id, b.id)
        tx = g1.new_transaction()
        assert [v.id for v in tx.vertex(a.id).out("link")] == [b.id]
        assert tx.vertex(c.id) is not None
        tx.rollback()
    finally:
        g1.close()
        g2.close()


def test_the_other_stores_still_refuse(tmp_path):
    # "remote" mounts a storage node (tests/test_torch_remote.py) and
    # "remote-cluster" a ring of them (tests/test_torch_cluster.py)
    with pytest.raises(NotImplementedError, match="item 11"):
        titan_tpu_torch.open({"storage.backend": "gdbm",
                              "storage.directory": str(tmp_path)})


def test_remote_cluster_over_sqlite_nodes_equals_jax(tmp_path):
    """``remote-cluster`` over two sqlite-backed storage nodes at
    replication 2: the same seeded operations give the same ids, and each
    node's sqlite rows hold the same unwrapped payloads in both
    packages."""
    import importlib
    got = {}
    for which in PKGS:
        root = "titan_tpu" if which == "jax" else "titan_tpu_torch"
        remote = importlib.import_module(f"{root}.storage.remote")
        sqlitekv = importlib.import_module(f"{root}.storage.sqlitekv")
        cluster = importlib.import_module(f"{root}.storage.cluster")
        dirs = [str(tmp_path / which / f"n{i}") for i in range(2)]
        nodes = [remote.KCVSServer(sqlitekv.SqliteStoreManager(d)).start()
                 for d in dirs]
        try:
            g = _open(which, {
                "storage.backend": "remote-cluster",
                "storage.hostname": [f"127.0.0.1:{n.port}" for n in nodes],
                "storage.cluster.replication-factor": 2,
                "storage.lock.wait-time": 5,
                "ids.authority.wait-time": 5}, seed=3)
            try:
                vids = run_ops(g, which, 3)
            finally:
                g.close()
        finally:
            for n in nodes:
                n.stop()
        got[which] = (vids, [sorted((k, c, cluster._unwrap(v)[2])
                                    for k, c, v, _ in table_rows(d,
                                                                 "edgestore"))
                             for d in dirs])
    assert got["port"] == got["jax"]
    assert got["port"][1][0] == got["port"][1][1] != []


# -- the change-log processors ----------------------------------------------

def _processed(which, g, ident: str, seed: int) -> list:
    """Register a processor on ``ident`` from the log's head, commit the
    seeded operations tagged, and return the states it saw, by content."""
    pkg = PKGS[which][0]
    seen = []
    pkg.open_log_processors(g).add_log_processor(ident) \
        .set_start_time(0).set_read_interval_ms(20) \
        .add_processor(lambda graph, txid, state: seen.append(
            (txid, state))).build()
    rng = np.random.default_rng(seed)
    tx = g.new_transaction()
    vs = [tx.add_vertex("node", name=f"v{i}") for i in range(6)]
    tx.commit()
    ids = [v.id for v in vs]
    for _ in range(3):
        tx = g.new_transaction(log_identifier=ident)
        a, b = (int(x) for x in rng.integers(0, 6, 2))
        tx.vertex(ids[a]).add_edge("link", tx.vertex(ids[b]))
        tx.vertex(ids[a]).property("name", f"w{b}")
        tx.commit()
    tx = g.new_transaction(log_identifier=ident)
    tx.vertex(ids[0]).remove()
    tx.commit()
    assert _wait_for(lambda: len(seen) >= 4), len(seen)
    out = []
    for txid, st in seen:
        assert txid == st.txid
        out.append({"added_vertices": sorted(st.added_vertices()),
                    "removed_vertices": sorted(st.removed_vertices()),
                    "added": sorted(str(r) for r in st.added_relations()),
                    "removed": sorted(str(r)
                                      for r in st.removed_relations())})
    return out


def test_log_processors_see_what_the_jax_processors_see():
    got = {}
    for which in PKGS:
        g = _open(which, "inmemory", seed=4)
        try:
            got[which] = _processed(which, g, "proc", 4)
        finally:
            g.close()
    assert len(got["port"]) == 4
    assert got["port"] == got["jax"]


def test_processor_and_message_errors_are_isolated():
    """A raising processor does not stop the others, and an undecodable
    message is skipped without wedging the stream."""
    g = titan_tpu_torch.open("inmemory")
    try:
        fw = titan_tpu_torch.open_log_processors(g)
        assert isinstance(fw, LogProcessorFramework)
        good = []

        def bad(graph, txid, state):
            raise RuntimeError("boom")

        fw.add_log_processor("iso").set_start_time(0) \
            .set_read_interval_ms(20).add_processor(bad) \
            .add_processor(lambda gr, txid, st: good.append(txid)).build()
        log = g.backend.log_manager.open_log(USER_LOG_PREFIX + "iso")
        log.add(b"\xff not a change state")
        tx = g.new_transaction()
        v = tx.add_vertex("node", name="x")
        tx.commit()
        tx = g.new_transaction(log_identifier="iso")
        tx.vertex(v.id).property("name", "y")
        tx.commit()
        tx = g.new_transaction(log_identifier="iso")
        tx.add_vertex("node", name="z")
        tx.commit()
        assert _wait_for(lambda: len(good) >= 2), good
        assert len(set(good)) == 2
    finally:
        g.close()


# -- the WAL (tests/test_coordination.py's TestWAL, mirrored) ---------------

def _wal_records(g) -> list:
    g._wal._log.flush()
    records = []
    wal = g._wal
    wal._log.register_reader(ReadMarker.from_time(0),
                             lambda m: records.append(wal.parse(m)))
    assert _wait_for(lambda: len(records) >= 3)
    return records


def test_commit_writes_wal_records():
    out = {}
    for which in PKGS:
        g = _open(which, {"storage.backend": "inmemory",
                          "tx.log-tx": "true"}, seed=6)
        try:
            mod = PKGS[which][3]
            assert isinstance(g._wal, mod.TransactionLog)
            tx = g.new_transaction()
            tx.add_vertex(name="walled")
            tx.commit()
            records = _wal_records(g)
            statuses = [s for _, s, _ in records]
            assert statuses == [mod.PRECOMMIT, mod.PRIMARY_SUCCESS,
                                mod.SECONDARY_SUCCESS]
            assert len({t for t, _, _ in records}) == 1
            payload = records[0][2]
            assert "edgestore" in payload and payload["edgestore"]
            out[which] = (statuses, payload)
        finally:
            g.close()
    # the same mutations, byte for byte, under the same statuses
    assert out["port"] == out["jax"]


def test_recovery_replays_lost_secondary():
    g = titan_tpu_torch.open({"storage.backend": "inmemory",
                              "tx.log-tx": "true"})
    try:
        wal = g._wal
        txid = wal.next_txid()
        # primary committed, secondary (graphindex) writes lost
        lost = {"graphindex": {b"idxkey": ([[b"col", b"val"]], [])}}
        wal.log_precommit(txid, lost)
        wal.log_primary_success(txid)
        wal._log.flush()
        recovery = PW.TransactionRecovery(g, wal._log, start_time=0,
                                          persistence_timeout_s=0.05)
        deadline = time.time() + 5
        while recovery.recovered < 1 and time.time() < deadline:
            recovery.force_sweep()
            time.sleep(0.05)
        assert recovery.recovered == 1
        txh = g.backend.manager.begin_transaction()
        got = g.backend.index_store.store.get_slice(
            KeySliceQuery(b"idxkey", SliceQuery()), txh)
        txh.commit()
        assert got == [Entry(b"col", b"val")]
    finally:
        g.close()


def test_the_trigger_log_is_tagged_with_the_wal_txid():
    """Under a WAL a tagged commit's change state carries the WAL's txid
    (without one, the commit timestamp)."""
    g = titan_tpu_torch.open({"storage.backend": "inmemory",
                              "tx.log-tx": "true"})
    try:
        seen = []
        titan_tpu_torch.open_log_processors(g).add_log_processor("t") \
            .set_start_time(0).set_read_interval_ms(20) \
            .add_processor(lambda gr, txid, st: seen.append(txid)).build()
        tx = g.new_transaction(log_identifier="t")
        tx.add_vertex("node", name="x")
        tx.commit()
        assert _wait_for(lambda: len(seen) >= 1)
        txids = {t for t, _, _ in _wal_records(g)}
        assert seen == sorted(txids)
    finally:
        g.close()
