"""The port's OLTP spine (titan_tpu_torch.open("inmemory")) against the
JAX package's: the same seeded DDL and transactions on both graphs give
byte-equal edgestore rows, equal vertex and relation ids, equal mutation
epochs and equal change payloads. The other stores (ids, locks, config)
carry the instance id and timestamps, so they are compared structurally
only. What the port leaves out raises NotImplementedError naming ROADMAP
queue 1, item 11; the sqlite store, the WAL and the log processors are
ported (tests/test_torch_sqlite_wal.py), and so are ``traversal()`` and
the graph, transaction and vertex queries (tests/test_torch_query.py,
tests/test_torch_traversal.py)."""

import numpy as np
import pytest

import titan_tpu
import titan_tpu_torch
from titan_tpu.core.defs import Cardinality as JCard, Multiplicity as JMult
from titan_tpu.ids.placement import SimpleBulkPlacement as JPlace
from titan_tpu_torch.core.defs import (Cardinality as PCard,
                                       Multiplicity as PMult)
from titan_tpu_torch.ids.placement import SimpleBulkPlacement as PPlace

PKGS = {"jax": (titan_tpu, JCard, JMult, JPlace),
        "port": (titan_tpu_torch, PCard, PMult, PPlace)}


def open_twin(which: str, seed: int = 11, config=None):
    """A graph whose partition placement is seeded, so both packages give
    the same ids for the same operations."""
    pkg, _, _, place = PKGS[which]
    g = pkg.open(config or "inmemory")
    g.id_assigner.placement = place(g.idm.num_partitions, batch_size=5,
                                    seed=seed)
    return g


def make_schema(g, which: str) -> None:
    _, card, mult, _ = PKGS[which]
    m = g.management()
    m.make_edge_label("knows", mult.MULTI)
    m.make_edge_label("likes", mult.SIMPLE)
    m.make_edge_label("mother", mult.MANY2ONE)
    m.make_property_key("name", str, card.SINGLE)
    m.make_property_key("age", int, card.SINGLE)
    m.make_property_key("tag", str, card.LIST)
    m.make_vertex_label("person")
    m.build_index("by_name").add_key("name").build_composite_index()
    m.commit()


def run_ops(g, which: str, seed: int) -> dict:
    """A seeded sequence of commits: vertices with properties, edges of
    three labels, then removals of edges, a vertex and a property.
    Returns the ids, relation ids and change payloads it saw."""
    make_schema(g, which)
    _, q = g.subscribe_changes()
    rng = np.random.default_rng(seed)
    tx = g.new_transaction()
    vs = [tx.add_vertex("person" if i % 3 else None, name=f"v{i}",
                        age=int(rng.integers(0, 90))) for i in range(24)]
    for v in vs[::4]:
        v.property("tag", "a")
        v.property("tag", "b")
    edges = []
    for _ in range(60):
        a, b = (int(x) for x in rng.integers(0, len(vs), 2))
        edges.append(vs[a].add_edge("knows", vs[b], since=int(a * b)))
    for a in range(0, 20, 2):
        vs[a].add_edge("likes", vs[a + 1])
    vs[5].add_edge("mother", vs[7])
    tx.commit()
    vids = [v.id for v in vs]
    rel_ids = sorted(e.rel.relation_id for e in edges)
    tx = g.new_transaction()
    for k in rng.choice(len(vids), 4, replace=False):
        v = tx.vertex(vids[int(k)])
        for e in list(v.out_edges("knows"))[:1]:
            e.remove()
    tx.vertex(vids[3]).remove()
    tx.vertex(vids[6]).property("age", 7)
    tx.commit()
    tx = g.new_transaction()
    tx.vertex(vids[0]).add_edge("knows", tx.vertex(vids[1]))
    tx.commit()
    return {"vids": vids, "rel_ids": rel_ids, "payloads": list(q),
            "epoch": g.mutation_epoch}


def edgestore_rows(g) -> list:
    store = g.backend.edge_store.store
    return [(k, list(c), list(v)) for k, c, v in
            store.scan_rows_packed(None)]


@pytest.fixture(scope="module", params=[1, 2])
def twins(request):
    seed = request.param
    out = {}
    for which in PKGS:
        g = open_twin(which)
        out[which] = (g, run_ops(g, which, seed))
    yield out
    for g, _ in out.values():
        g.close()


def test_edgestore_rows_are_byte_equal(twins):
    rows_j = edgestore_rows(twins["jax"][0])
    rows_p = edgestore_rows(twins["port"][0])
    assert len(rows_j) > 24
    assert rows_p == rows_j


def test_ids_epochs_and_payloads_are_equal(twins):
    (_, j), (_, p) = twins["jax"], twins["port"]
    assert p["vids"] == j["vids"]
    assert p["rel_ids"] == j["rel_ids"]
    assert p["epoch"] == j["epoch"] == 3      # the three data commits
    strip = [{k: v for k, v in x.items() if k != "time"}
             for x in j["payloads"]]
    assert [{k: v for k, v in x.items() if k != "time"}
            for x in p["payloads"]] == strip
    assert len(strip) == 3


def test_schema_type_ids_and_reads_are_equal(twins):
    (gj, j), (gp, _) = twins["jax"], twins["port"]
    for name in ("knows", "likes", "mother", "name", "age", "tag",
                 "person", "by_name"):
        assert gp.schema.get_by_name(name).id == \
            gj.schema.get_by_name(name).id, name
    txj, txp = gj.new_transaction(), gp.new_transaction()
    try:
        for vid in j["vids"]:
            vj, vp = txj.vertex(vid), txp.vertex(vid)
            assert (vj is None) == (vp is None)
            if vj is None:
                continue
            assert vp.value("age") == vj.value("age")
            assert sorted(vp.values("tag")) == sorted(vj.values("tag"))
            assert sorted(w.id for w in vp.out("knows")) == \
                sorted(w.id for w in vj.out("knows"))
    finally:
        txj.rollback()
        txp.rollback()


def test_other_stores_agree_structurally(twins):
    """The id, lock and config stores hold the same row keys and column
    counts (their values carry the instance id and timestamps)."""
    for name in ("graphindex", "system_ids", "system_properties"):
        shapes = []
        for g, _ in twins.values():
            store = g.backend.manager.open_database(name)
            shapes.append([(k, len(c)) for k, c, _ in
                           store.scan_rows_packed(None)])
        assert shapes[0] == shapes[1], name


def test_change_queue_overflows_at_its_cap():
    from titan_tpu_torch.config import defaults
    from titan_tpu_torch.core.changes import CHANGE_QUEUE_CAP, ChangeQueue
    assert CHANGE_QUEUE_CAP == defaults.TPU_CHANGE_BACKLOG.default == 10_000
    q = ChangeQueue(cap=2)
    for e in (1, 2, 3):
        q.push({"epoch": e})
    assert q.overflowed and len(q) == 0
    q.reanchor()
    q.push({"epoch": 4})
    assert not q.overflowed and list(q) == [{"epoch": 4}]


def test_listeners_are_held_weakly():
    import gc
    g = titan_tpu_torch.open("inmemory")
    try:
        token, q = g.subscribe_changes()
        assert len(g._change_listeners) == 1
        del q
        gc.collect()
        assert len(g._change_listeners) == 0
        g.unsubscribe_changes(token)          # unknown tokens are fine
    finally:
        g.close()


@pytest.mark.parametrize("backend", ["gdbm"])
def test_other_stores_name_their_roadmap_item(backend):
    """``remote`` mounts a storage node (tests/test_torch_remote.py),
    ``remote-cluster`` a ring of them (tests/test_torch_cluster.py)."""
    with pytest.raises(NotImplementedError, match="item 11"):
        titan_tpu_torch.open({"storage.backend": backend,
                              "storage.directory": "unused"})


def test_remote_cluster_opens_and_equals_jax():
    """``storage.backend: remote-cluster`` over two storage nodes at
    replication 2: twin graphs give the same ids and the same unwrapped
    edgestore rows."""
    import importlib
    got = {}
    for which in PKGS:
        root = PKGS[which][0].__name__
        server = importlib.import_module(f"{root}.storage.remote").KCVSServer
        mem = importlib.import_module(
            f"{root}.storage.inmemory").InMemoryStoreManager
        api = importlib.import_module(f"{root}.storage.api")
        nodes = [server(mem()).start() for _ in range(2)]
        try:
            g = open_twin(which, config={
                "storage.backend": "remote-cluster",
                "storage.hostname": [f"127.0.0.1:{n.port}" for n in nodes],
                "storage.cluster.replication-factor": 2,
                "storage.lock.wait-time": 5, "ids.authority.wait-time": 5})
            try:
                res = run_ops(g, which, 1)
                txh = g.backend.manager.begin_transaction()
                rows = sorted((k, [(e.column, e.value) for e in es])
                              for k, es in g.backend.edge_store.store
                              .get_keys(api.SliceQuery(), txh))
            finally:
                g.close()
        finally:
            for n in nodes:
                n.stop()
        got[which] = (res["vids"], res["rel_ids"], rows)
    assert got["port"] == got["jax"]
    assert len(got["port"][2]) > 0


def test_sqlite_store_keeps_commits_across_a_reopen(tmp_path):
    """tests/test_torch_sqlite_wal.py holds the rows to the JAX store."""
    config = {"storage.backend": "sqlite",
              "storage.directory": str(tmp_path / "db")}
    g = titan_tpu_torch.open(config)
    tx = g.new_transaction()
    vid = tx.add_vertex("node", name="kept").id
    tx.commit()
    g.close()
    g = titan_tpu_torch.open(config)
    try:
        assert g.new_transaction().vertex(vid).value("name") == "kept"
    finally:
        g.close()


@pytest.mark.parametrize("config", [
    {"metrics.enabled": True}, {"storage.backend": "gdbm"}])
def test_refused_options_name_their_roadmap_item(config):
    """``index.<name>.backend`` opens its provider now
    (``test_formerly_refused_calls_equal_jax``)."""
    with pytest.raises(NotImplementedError, match="item 11"):
        titan_tpu_torch.open({"storage.backend": "inmemory", **config})


def test_log_tx_option_builds_the_wal():
    """tests/test_torch_sqlite_wal.py holds the records to the JAX WAL."""
    from titan_tpu_torch.core.wal import TransactionLog
    g = titan_tpu_torch.open({"storage.backend": "inmemory",
                              "tx.log-tx": True})
    try:
        assert isinstance(g._wal, TransactionLog)
        tx = g.new_transaction()
        tx.add_vertex(name="walled")
        tx.commit()
    finally:
        g.close()


def _knows_out(vertices) -> int:
    return sum(len(list(v.out("knows"))) for v in vertices)


#: each entry's builder answers a one-hop count: the knows edges out of
#: the vertices it selects
ENTRIES = {
    "traversal": lambda g, P, D: g.traversal().V().has("age", P.gt(40))
    .out("knows").count().next(),
    "query": lambda g, P, D: _knows_out(
        g.query().has("age", P.gt(40)).vertices()),
    "tx.query": lambda g, P, D: _knows_out(
        g.new_transaction().query().has_label("person").vertices()),
    "vertex.query": lambda g, P, D: sum(
        v.query().labels("knows").direction(D.OUT).count()
        for v in g.new_transaction().vertices()),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_query_and_traversal_entries_answer_as_jax(twins, entry):
    """``traversal()``, ``query()``, ``tx.query()`` and ``vertex.query()``
    answer on the port; each one-hop count equals JAX's on twins."""
    from titan_tpu.core.defs import Direction as JD
    from titan_tpu.query.predicates import P as JP
    from titan_tpu_torch.core.defs import Direction as PD
    from titan_tpu_torch.query.predicates import P as PP
    got = ENTRIES[entry](twins["port"][0], PP, PD)
    assert got == ENTRIES[entry](twins["jax"][0], JP, JD)
    assert got > 0


@pytest.mark.parametrize("call", [lambda g: g.compute(backend="tpu")],
                         ids=["tpu"])
def test_refused_methods_name_their_roadmap_item(call):
    g = titan_tpu_torch.open("inmemory")
    try:
        m = g.management()
        m.make_property_key("k", str)
        m.build_index("ci").add_key("k").build_composite_index()
        m.commit()
        with pytest.raises(NotImplementedError, match="item 11"):
            call(g)
    finally:
        g.close()


#: the calls that once raised, each on a twin graph with a key
#: ``k``, a composite index ``ci`` and a ``search`` provider; what each
#: returns in a package-free form
FORMERLY_REFUSED = {
    "index_query": lambda g, which: [
        (el.id, s) for el, s in g.index_query("m", "k:hello")],
    "index_provider": lambda g, which: (
        type(g.index_provider("search")).__name__,
        g.index_provider("search").features.supports_raw_query,
        type(g.index_provider("other")).__name__),
    "host": lambda g, which: sorted(
        (vid, st.get("n")) for vid, st in g.compute(backend="host").run(
            _count_program(which), max_iterations=3).states.items()),
    "mixed_index": lambda g, which: (
        lambda ix: (ix.name, ix.composite, ix.backing, ix.status.value,
                    ix.key_params))(g.schema.get_by_name("m")),
    "reindex": lambda g, which: (
        g.management().update_index("late", "reindex").status.value,
        sorted(v.id for v in g.new_transaction().query().has(
            "j", "b1").vertices())),
}


def _count_program(which):
    api = __import__(f"{PKGS[which][0].__name__}.olap.api",
                     fromlist=["VertexProgram"])

    class Count(api.VertexProgram):
        def execute(self, vertex, messenger, memory):
            vertex.set_state("n", memory.iteration + 1)

        def terminate(self, memory):
            return memory.iteration >= 1
    return Count()


@pytest.mark.parametrize("name", sorted(FORMERLY_REFUSED))
def test_formerly_refused_calls_equal_jax(name):
    got = {}
    for which in ("jax", "port"):
        g = open_twin(which, config={"storage.backend": "inmemory",
                                     "index.search.backend": "memindex"})
        try:
            m = g.management()
            m.make_property_key("k", str)
            m.make_property_key("j", str)
            m.build_index("ci").add_key("k").build_composite_index()
            m.build_index("m").add_key("k", "TEXT") \
                .build_mixed_index("search")
            m.commit()
            tx = g.new_transaction()
            for i in range(4):
                tx.add_vertex("node", k=f"hello {i}", j=f"b{i}")
            tx.commit()
            m = g.management()
            m.build_index("late").add_key("j").build_composite_index()
            m.update_index("late", "register")
            got[which] = FORMERLY_REFUSED[name](g, which)
        finally:
            g.close()
    assert got["port"] == got["jax"]
    assert got["port"] not in ([], None)

def test_open_log_processors_returns_the_framework():
    """tests/test_torch_sqlite_wal.py holds the processors to JAX's."""
    from titan_tpu_torch.core.changes import LogProcessorFramework
    g = titan_tpu_torch.open("inmemory")
    try:
        fw = titan_tpu_torch.open_log_processors(g)
        assert isinstance(fw, LogProcessorFramework) and fw.graph is g
    finally:
        g.close()


def test_the_port_graph_defaults_to_the_gpu_computer(monkeypatch):
    import torch
    g = titan_tpu_torch.open("inmemory")
    try:
        assert type(g.compute(device="cpu")).__name__ == "GPUGraphComputer"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            g.compute()
    finally:
        g.close()
