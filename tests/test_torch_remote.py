"""The port's remote store (``titan_tpu_torch/storage/remote.py``) against
the JAX package's: the KCVS contract over HTTP in every pairing of client
and storage node (the wire is the same JSON), graphs over either node
leaving an edgestore byte-equal to an ``inmemory`` twin, and the
registry's ``remote`` entry beside the refusals that stay."""

import time

import pytest

import titan_tpu
import titan_tpu_torch
from titan_tpu.storage import api as japi
from titan_tpu.storage import remote as jremote
from titan_tpu.storage.inmemory import InMemoryStoreManager as JMem
from titan_tpu_torch.errors import TemporaryBackendError
from titan_tpu_torch.storage import api as papi
from titan_tpu_torch.storage import remote as premote
from titan_tpu_torch.storage.inmemory import InMemoryStoreManager as PMem
from torch_twins import canon, open_twin, people

#: per package: (storage api, remote module, in-memory manager, open)
PKGS = {"jax": (japi, jremote, JMem, titan_tpu.open),
        "port": (papi, premote, PMem, titan_tpu_torch.open)}

#: (client package, storage-node package): every pairing of the wire
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port"),
         ("jax", "jax")]


@pytest.fixture(params=["port", "jax"])
def node(request):
    _, remote, mem, _ = PKGS[request.param]
    server = remote.KCVSServer(mem()).start()
    yield server
    server.stop()


def _client(pkg: str, node_pkg: str):
    """A started node of ``node_pkg`` and a client manager of ``pkg``."""
    _, remote, mem, _ = PKGS[node_pkg]
    server = remote.KCVSServer(mem()).start()
    return server, PKGS[pkg][1].RemoteStoreManager("127.0.0.1",
                                                   server.port)


def _kcvs_ops(pkg: str, mgr) -> list:
    """The KCVS round trips of the JAX package's remote tests, returning
    every read in a package-free form."""
    api = PKGS[pkg][0]
    E, SQ = api.Entry, api.SliceQuery
    store = mgr.open_database("s")
    txh = mgr.begin_transaction()
    out = []

    def rows(entries):
        return [(e.column, e.value) for e in entries]

    store.mutate(b"k", [E(b"a", b"1"), E(b"b", b"2")], [], txh)
    out.append(rows(store.get_slice(api.KeySliceQuery(b"k", SQ()), txh)))
    out.append(rows(store.get_slice(api.KeySliceQuery(b"k", SQ(b"b")),
                                    txh)))
    out.append(rows(store.get_slice(
        api.KeySliceQuery(b"k", SQ(b"a", b"b", 1)), txh)))
    store.mutate(b"k", [], [b"a"], txh)
    out.append(rows(store.get_slice(api.KeySliceQuery(b"k", SQ()), txh)))
    for i in range(600):          # more than one scan page of 512 keys
        store.mutate(b"r%04d" % i, [E(b"c", b"%d" % i)], [], txh)
    multi = store.get_slice_multi([b"r0003", b"r0007", b"none"], SQ(), txh)
    out.append(sorted((k, rows(v)) for k, v in multi.items()))
    out.append([(k, rows(v)) for k, v in store.get_keys(
        api.KeyRangeQuery(b"r0010", b"r0020", SQ()), txh)])
    out.append([(k, rows(v)) for k, v in store.get_keys(
        api.KeyRangeQuery(b"r0500", b"r0590", SQ(), key_limit=7), txh)])
    scan = [k for k, _ in store.get_keys(SQ(), txh)]
    out.append((len(scan), scan == sorted(scan)))
    out.append((mgr.name, mgr.exists(), mgr.features.cell_ttl,
                mgr.features.key_consistent, mgr.features.transactional))
    return out


@pytest.mark.parametrize("pkg,node_pkg", PAIRS)
def test_kcvs_round_trips_equal_in_every_pairing(pkg, node_pkg):
    server, mgr = _client(pkg, node_pkg)
    try:
        got = _kcvs_ops(pkg, mgr)
    finally:
        server.stop()
    ref_server, ref = _client("jax", "jax")
    try:
        want = _kcvs_ops("jax", ref)
    finally:
        ref_server.stop()
    assert got == want
    assert got[0] == [(b"a", b"1"), (b"b", b"2")]
    assert got[7] == (601, True)       # the 600 rows and "k", in order


@pytest.mark.parametrize("pkg,node_pkg", PAIRS)
def test_ttl_and_clear_pass_through(pkg, node_pkg):
    server, mgr = _client(pkg, node_pkg)
    api = PKGS[pkg][0]
    try:
        store = mgr.open_database("s")
        txh = mgr.begin_transaction()
        store.mutate(b"k", [api.TTLEntry(b"t", b"v", 0.05),
                            api.Entry(b"p", b"w")], [], txh)
        time.sleep(0.08)
        res = store.get_slice(api.KeySliceQuery(b"k", api.SliceQuery()),
                              txh)
        assert [(e.column, e.value) for e in res] == [(b"p", b"w")]
        mgr.clear_storage()
        assert store.get_slice(api.KeySliceQuery(b"k", api.SliceQuery()),
                               txh) == []
    finally:
        server.stop()


def test_connection_failure_is_temporary():
    with pytest.raises(TemporaryBackendError):
        premote.RemoteStoreManager("127.0.0.1", 1)   # nothing listening


def test_unknown_endpoint_and_admin_op_are_permanent(node):
    from titan_tpu_torch.errors import PermanentBackendError
    from titan_tpu_torch.utils.httpnode import json_call
    with pytest.raises(PermanentBackendError, match="unknown endpoint"):
        json_call(node.url, "/nope", {})
    with pytest.raises(PermanentBackendError, match="unknown admin op"):
        json_call(node.url, "/admin", {"op": "explode"})


def _remote_config(port: int) -> dict:
    # short claim waits: one process on one loopback node has no clock
    # skew to wait out (both packages read the same two options)
    return {"storage.backend": "remote", "storage.hostname": "127.0.0.1",
            "storage.port": port, "storage.lock.wait-time": 5,
            "ids.authority.wait-time": 5}


def _rows(store) -> list:
    return [(k, list(c), list(v)) for k, c, v in
            store.scan_rows_packed(None)]


@pytest.mark.parametrize("pkg,node_pkg", PAIRS[:3])
def test_graph_over_remote_is_byte_equal_to_inmemory(pkg, node_pkg):
    """The same seeded commits through ``storage.backend=remote`` leave
    the node's edgestore byte-equal to an ``inmemory`` twin's, and the
    graph reads back what it wrote."""
    _, remote, mem, _ = PKGS[node_pkg]
    backing = mem()
    server = remote.KCVSServer(backing).start()
    twin = people(pkg)
    try:
        g = people(pkg, config=_remote_config(server.port))
        try:
            assert g.backend.manager.name == "remote"
            want = _rows(twin.backend.edge_store.store)
            assert len(want) > 40     # the 40 persons and the schema
            assert _rows(backing.open_database("edgestore")) == want
            for q in ("g.V().has('name', 'p3').out('knows')",
                      "g.V().has('age', 27).both().dedup()"):
                got = eval(q, {"g": g.traversal()}).to_list()
                ref = eval(q, {"g": twin.traversal()}).to_list()
                assert sorted(map(canon, got)) == sorted(map(canon, ref))
        finally:
            g.close()
    finally:
        server.stop()
        twin.close()


def test_unique_index_holds_over_the_remote_store(node):
    """Locking and the id authority run over a store that declares no
    transactions: a unique index still refuses the second holder."""
    from titan_tpu_torch.errors import SchemaViolationError
    g = titan_tpu_torch.open(_remote_config(node.port))
    try:
        tx = g.new_transaction()
        a = tx.add_vertex("person", name="alice")
        a.add_edge("knows", tx.add_vertex("person", name="bob"))
        aid = a.id
        tx.commit()
        assert g.traversal().V(aid).out("knows").count().next() == 1
        mgmt = g.management()
        key = mgmt.make_property_key("email", str)
        mgmt.build_index("byEmail", "vertex").add_key(key).unique() \
            .build_composite_index()
        mgmt.commit()
        tx = g.new_transaction()
        tx.vertex(aid).property("email", "a@x")
        tx.commit()
        tx = g.new_transaction()
        tx.add_vertex("person", name="eve", email="a@x")
        with pytest.raises(SchemaViolationError):
            tx.commit()
    finally:
        g.close()


def test_two_instances_share_a_node_and_snapshot_it(node):
    """Two port graphs on one node see each other's commits, and a
    snapshot built over the remote store equals the in-memory one."""
    from titan_tpu_torch import example
    from titan_tpu_torch.olap import snapshot as snap_mod
    cfg = _remote_config(node.port)
    g1 = titan_tpu_torch.open(dict(cfg, **{"graph.unique-instance-id":
                                           "r1"}))
    g2 = titan_tpu_torch.open(dict(cfg, **{"graph.unique-instance-id":
                                           "r2"}))
    ref = titan_tpu_torch.open("inmemory")
    try:
        example.load(g1)
        example.load(ref)
        tx = g2.new_transaction()
        names = sorted(v.value("name") for v in tx.vertices())
        tx.rollback()
        assert len(names) == 12 and "hercules" in names
        assert set(g1.management().get_open_instances()) == {"r1", "r2"}
        s_remote = snap_mod.build(g2)
        s_ref = snap_mod.build(ref)
        assert (s_remote.n, s_remote.num_edges) == (12, 17)
        assert (s_ref.n, s_ref.num_edges) == (12, 17)
    finally:
        g2.close()
        g1.close()
        ref.close()


def test_registry_mounts_remote_and_refuses_the_rest(node):
    from titan_tpu_torch.storage.registry import store_manager
    mgr = store_manager("remote", hostname=[f"127.0.0.1"],
                        port=node.port, timeout=5)
    assert isinstance(mgr, premote.RemoteStoreManager)
    assert mgr.exists() is False or mgr.exists() is True
    # gdbm is registered (tests/test_torch_gdbm.py) and, like the JAX
    # package's, refuses to open without a directory
    with pytest.raises(ValueError, match="storage.directory"):
        store_manager("gdbm", hostname="127.0.0.1", port=node.port)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_registry_mounts_remote_cluster_like_jax(node, client):
    """The registry's ``remote-cluster`` entry: a one-node ring over either
    package's node, mounted by either package's registry, reads back what
    the other package's ring wrote."""
    import importlib
    reg = {w: importlib.import_module(
        f"{'titan_tpu' if w == 'jax' else 'titan_tpu_torch'}.storage"
        ".registry") for w in PKGS}
    other = "jax" if client == "port" else "port"
    mgrs = {w: reg[w].store_manager(
        "remote-cluster", hostname=[f"127.0.0.1:{node.port}"],
        port=node.port, replication=1, write_consistency="all",
        virtual_nodes=8, timeout=5) for w in PKGS}
    assert {type(m).__name__ for m in mgrs.values()} == \
        {"ClusterStoreManager"}
    api = PKGS[client][0]
    store = mgrs[client].open_database("rc")
    txh = mgrs[client].begin_transaction()
    store.mutate(b"k", [api.Entry(b"a", b"1"), api.Entry(b"b", b"2")], [],
                 txh)
    back = mgrs[other].open_database("rc").get_slice(
        PKGS[other][0].KeySliceQuery(b"k", PKGS[other][0].SliceQuery()),
        mgrs[other].begin_transaction())
    assert [(e.column, e.value) for e in back] == [(b"a", b"1"),
                                                  (b"b", b"2")]
    for m in mgrs.values():
        m.close()


def test_storage_node_cli_needs_a_directory(capsys):
    with pytest.raises(SystemExit) as exc:
        premote.main([])
    assert exc.value.code == 2
    assert "titan_tpu_torch.storage.remote" in capsys.readouterr().err
