"""The port's sharded and replicated store (``titan_tpu_torch/storage/
cluster.py``, ``storage.backend: remote-cluster``) against the JAX
package's: every scenario of ``tests/test_cluster.py`` runs in both
packages, each over storage nodes of its own, and the answers must be
equal. The ring's placement is compared for thousands of seeded keys; the
cells byte for byte under a clock pinned in both modules (the nodes of both
runs listen on the same ports, since the ring hashes the addresses); each
package's client also mounts the other package's nodes."""

import importlib
import random
import socket
import threading
import time

import pytest

from torch_twins import canon, open_twin

ROOT = {"jax": "titan_tpu", "port": "titan_tpu_torch"}
BOTH = ("jax", "port")


def mod(which: str, name: str):
    return importlib.import_module(f"{ROOT[which]}.{name}")


class Nodes:
    """``count`` storage nodes of one package over in-memory stores."""

    def __init__(self, which: str, count: int = 3, ports=None):
        remote = mod(which, "storage.remote")
        mem = mod(which, "storage.inmemory").InMemoryStoreManager
        self.which = which
        self.remote = remote
        self.servers = [remote.KCVSServer(
            mem(), port=(ports[i] if ports else 0)).start()
            for i in range(count)]

    @property
    def hosts(self) -> list:
        return [f"127.0.0.1:{s.port}" for s in self.servers]

    def stop(self, i: int) -> None:
        self.servers[i].stop()

    def restart(self, i: int) -> None:
        """Revive a stopped node on its port with its surviving store."""
        s = self.servers[i]
        self.servers[i] = self.remote.KCVSServer(s.manager,
                                                 port=s.port).start()

    def close(self) -> None:
        for s in self.servers:
            s.stop()

    def dump(self) -> list:
        """Each node's raw contents: {store: [(key, [(col, value)])]}."""
        a = api(self.which)
        out = []
        for s in self.servers:
            stores = {}
            txh = s.manager.begin_transaction()
            for name in sorted(s.manager._stores):
                st = s.manager.open_database(name)
                stores[name] = sorted(
                    (k, [(e.column, e.value) for e in es])
                    for k, es in st.get_keys(a.SliceQuery(), txh))
            out.append(stores)
        return out


def run_both(scenario, count: int = 3):
    """``scenario(which, nodes)`` in each package over its own nodes, on
    the same ports in both runs (the ring hashes the addresses); new
    ports if another process took one between the runs."""
    for attempt in range(3):
        got = {}
        ports = _free_ports(count)
        try:
            for which in BOTH:
                nodes = Nodes(which, count, ports=ports)
                try:
                    got[which] = scenario(which, nodes)
                finally:
                    nodes.close()
            break
        except OSError:
            if attempt == 2:
                raise
    assert got["port"] == got["jax"]
    return got["port"]


def manager(which, hosts, rf=2, wc="all", **kw):
    return mod(which, "storage.cluster").ClusterStoreManager(
        hosts, replication=rf, write_consistency=wc, virtual_nodes=16, **kw)


def rows(entries) -> list:
    return [(e.column, e.value) for e in entries]


def api(which):
    return mod(which, "storage.api")


# -- the ring and the cells ---------------------------------------------------

@pytest.mark.parametrize("peers,rf,vnodes", [(5, 3, 32), (4, 1, 64),
                                             (3, 2, 16), (2, 5, 8)])
def test_ring_replicas_equal_jax(peers, rf, vnodes):
    ids = [f"10.0.0.{i}:8283" for i in range(peers)]
    rings = {w: mod(w, "storage.cluster").HashRing(peers, rf, vnodes, ids)
             for w in BOTH}
    rng = random.Random(7)
    keys = [rng.randbytes(rng.randint(1, 24)) for _ in range(3000)]
    got = [rings["port"].replicas(k) for k in keys]
    assert got == [rings["jax"].replicas(k) for k in keys]
    want = min(rf, peers)
    assert all(len(r) == want == len(set(r)) for r in got)
    if rf == 1:
        counts = [sum(r[0] == p for r in got) for p in range(peers)]
        assert min(counts) > 300            # no starving node


def test_cells_wrap_and_unwrap_equal_jax():
    cases = [(0, b"", False, 0.0), (1, b"v", True, 0.0),
             (2 ** 63 + 5, b"\x00\xce" * 9, False, 1.7e9 + 0.25),
             (123456789, b"payload", True, 12.5)]
    for ts, payload, tomb, expiry in cases:
        cells = {w: mod(w, "storage.cluster")._wrap(ts, payload, tomb,
                                                    expiry) for w in BOTH}
        assert cells["port"] == cells["jax"]
        for w in BOTH:
            assert mod(w, "storage.cluster")._unwrap(cells["port"]) == \
                (ts, tomb, payload, expiry)
    for legacy in (b"", b"short", b"\x01" * 40):
        assert mod("port", "storage.cluster")._unwrap(legacy) == \
            mod("jax", "storage.cluster")._unwrap(legacy) == \
            (0, False, legacy, 0.0)


def _free_ports(k: int) -> list:
    socks = [socket.socket() for _ in range(k)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _pinned_writes(which, hosts, wc):
    a = api(which)
    mgr = manager(which, hosts, rf=2, wc=wc, read_repair=0.0)
    store = mgr.open_database("s")
    txh = mgr.begin_transaction()
    for i in range(40):
        store.mutate(b"k%03d" % i, [a.Entry(b"c", b"%d" % i),
                                    a.Entry(b"d", b"x" * (i % 5))], [], txh)
    for i in range(0, 40, 3):
        store.mutate(b"k%03d" % i, [], [b"d"], txh)          # tombstones
    store.mutate(b"ttl", [a.TTLEntry(b"c", b"t", 3600)], [], txh)
    mgr.close()


@pytest.mark.parametrize("wc", ["all", "quorum", "one"])
def test_cells_byte_equal_under_a_pinned_clock(monkeypatch, wc):
    """The same writes leave the same bytes on every node: both packages'
    ``next_ts`` read the one ``time`` module, pinned here, and the nodes
    of both runs listen on the same ports, so the ring places alike."""
    t0 = 1_700_000_000_000_000_000
    monkeypatch.setattr(time, "time_ns", lambda: t0)
    monkeypatch.setattr(time, "time", lambda: t0 / 1e9)
    ports = _free_ports(3)
    dumps = {}
    for which in BOTH:
        nodes = Nodes(which, 3, ports=ports)
        try:
            _pinned_writes(which, nodes.hosts, wc)
            dumps[which] = nodes.dump()
        finally:
            nodes.close()
    assert dumps["port"] == dumps["jax"]
    assert sum(len(d["s"]) for d in dumps["port"]) == 2 * 41


@pytest.mark.parametrize("client,node", [("port", "jax"), ("jax", "port")])
def test_a_client_mounts_the_other_packages_nodes(monkeypatch, client,
                                                  node):
    """The ring's wire is the remote store's: a client of one package over
    nodes of the other leaves the bytes its own nodes would hold, and the
    other package's client reads them back."""
    t0 = 1_700_000_000_000_000_000
    monkeypatch.setattr(time, "time_ns", lambda: t0)
    monkeypatch.setattr(time, "time", lambda: t0 / 1e9)
    ports = _free_ports(3)
    dumps = {}
    for which, node_pkg in ((client, client), (client, node)):
        nodes = Nodes(node_pkg, 3, ports=ports)
        try:
            _pinned_writes(which, nodes.hosts, "quorum")
            dumps[node_pkg] = nodes.dump()
            if node_pkg == node:
                a = api(node)
                mgr = manager(node, nodes.hosts, rf=2, wc="quorum")
                store = mgr.open_database("s")
                txh = mgr.begin_transaction()
                got = [rows(store.get_slice(a.KeySliceQuery(
                    b"k%03d" % i, a.SliceQuery()), txh)) for i in range(40)]
                keys = sorted(k for k, _ in store.get_keys(
                    a.SliceQuery(), txh))
                mgr.close()
        finally:
            nodes.close()
    assert dumps[node] == dumps[client]
    assert got[4] == [(b"c", b"4"), (b"d", b"xxxx")]
    assert got[3] == [(b"c", b"3")]
    assert keys == sorted([b"k%03d" % i for i in range(40)] + [b"ttl"])


# -- the store: reads, scans, consistency levels ------------------------------

def test_slice_and_scan_with_replication():
    def scen(which, nodes):
        a = api(which)
        mgr = manager(which, nodes.hosts, rf=2)
        store = mgr.open_database("s")
        txh = mgr.begin_transaction()
        for i in range(60):
            store.mutate(b"k%03d" % i, [a.Entry(b"c", b"%d" % i)], [], txh)
        one = rows(store.get_slice(a.KeySliceQuery(b"k007", a.SliceQuery()),
                                   txh))
        multi = store.get_slice_multi([b"k003", b"k017", b"k042"],
                                      a.SliceQuery(), txh)
        ordered = [k for k, _ in store.get_keys(a.KeyRangeQuery(
            b"k010", b"k030", a.SliceQuery()), txh)]
        # an unordered scan yields each key from its first alive replica,
        # in node order: a multiset
        unordered = sorted(k for k, _ in store.get_keys(a.SliceQuery(), txh))
        mgr.close()
        return one, {k: rows(v) for k, v in multi.items()}, ordered, \
            unordered
    one, multi, ordered, unordered = run_both(scen)
    assert one == [(b"c", b"7")] and multi[b"k042"] == [(b"c", b"42")]
    assert ordered == [b"k%03d" % i for i in range(10, 30)]
    assert unordered == [b"k%03d" % i for i in range(60)]


def test_reads_survive_node_failure_with_rf2():
    def scen(which, nodes):
        a = api(which)
        mgr = manager(which, nodes.hosts, rf=2)
        store = mgr.open_database("s")
        txh = mgr.begin_transaction()
        for i in range(40):
            store.mutate(b"k%03d" % i, [a.Entry(b"c", b"%d" % i)], [], txh)
        nodes.stop(1)
        got = [rows(store.get_slice(a.KeySliceQuery(
            b"k%03d" % i, a.SliceQuery()), txh)) for i in range(40)]
        keys = sorted(k for k, _ in store.get_keys(a.SliceQuery(), txh))
        mgr.close()
        return got, keys
    got, keys = run_both(scen)
    assert got == [[(b"c", b"%d" % i)] for i in range(40)]
    assert keys == [b"k%03d" % i for i in range(40)]


@pytest.mark.parametrize("wc", ["all", "quorum", "one"])
def test_write_consistency_with_a_dead_node(wc):
    """``all`` refuses a write that a dead replica owns, ``quorum`` (rf 2:
    both) too, ``one`` takes it and reads it back."""
    def scen(which, nodes):
        a = api(which)
        errors = mod(which, "errors")
        mgr = manager(which, nodes.hosts, rf=2, wc=wc)
        store = mgr.open_database("s")
        txh = mgr.begin_transaction()
        store.mutate(b"k1", [a.Entry(b"c", b"1")], [], txh)
        nodes.stop(2)
        written = 0
        try:
            for i in range(60):
                store.mutate(b"w%03d" % i, [a.Entry(b"c", b"x")], [], txh)
                written += 1
            refused = None
        except errors.TemporaryBackendError:
            refused = written
        back = [rows(store.get_slice(a.KeySliceQuery(
            b"w%03d" % i, a.SliceQuery()), txh)) for i in range(written)]
        mgr.close()
        return refused, back
    refused, back = run_both(scen)
    if wc == "one":
        assert refused is None and back == [[(b"c", b"x")]] * 60
    else:
        assert refused is not None and refused < 60


def test_key_consistent_flag_equals_jax():
    def scen(which, nodes):
        out = []
        for rf, wc in ((2, "one"), (2, "quorum"), (1, "one"), (2, "all")):
            m = mod(which, "storage.cluster").ClusterStoreManager(
                nodes.hosts, replication=rf, write_consistency=wc,
                virtual_nodes=8)
            out.append(m.features.key_consistent)
            m.close()
        return out
    assert run_both(scen, count=2) == [False, True, True, True]


def test_same_batch_add_and_delete_add_wins():
    def scen(which, nodes):
        a = api(which)
        mgr = manager(which, nodes.hosts, rf=2, wc="all")
        store = mgr.open_database("e")
        txh = a.StoreTransaction(None)
        store.mutate(b"k", [a.Entry(b"c", b"v1")], [b"c"], txh)
        got = rows(store.get_slice(a.KeySliceQuery(
            b"k", a.SliceQuery(b"", b"\xff")), txh))
        mgr.close()
        return got
    assert run_both(scen) == [(b"c", b"v1")]


# -- recovery: hints, read repair, tombstones, compaction ---------------------

def test_hinted_handoff_converges_revived_replica():
    def scen(which, nodes):
        a = api(which)
        mgr = manager(which, nodes.hosts, rf=2, wc="one")
        store = mgr.open_database("s")
        txh = mgr.begin_transaction()
        store.mutate(b"seed", [a.Entry(b"c", b"0")], [], txh)
        key = b"hh-key"
        victim, survivor = mgr.ring.replicas(key)[:2]
        nodes.stop(victim)
        store.mutate(key, [a.Entry(b"c", b"v1")], [], txh)
        queued = len(mgr._hints.get(victim) or ())
        nodes.restart(victim)
        up = mgr.is_up(victim)
        left = len(mgr._hints.get(victim) or ())
        nodes.stop(survivor)
        got = rows(store.get_slice(a.KeySliceQuery(key, a.SliceQuery()),
                                   txh))
        mgr.close()
        return queued, up, left, got
    assert run_both(scen) == (1, True, 0, [(b"c", b"v1")])


def test_read_repair_converges_without_hints():
    def scen(which, nodes):
        a = api(which)
        mgr = manager(which, nodes.hosts, rf=3, wc="quorum", read_repair=1.0)
        store = mgr.open_database("s")
        txh = mgr.begin_transaction()
        key = b"rr-key"
        victim = mgr.ring.replicas(key)[0]
        nodes.stop(victim)
        store.mutate(key, [a.Entry(b"c", b"new")], [], txh)
        mgr.close()
        nodes.restart(victim)
        mgr2 = manager(which, nodes.hosts, rf=3, wc="quorum",
                       read_repair=1.0)
        got = rows(mgr2.open_database("s").get_slice(
            a.KeySliceQuery(key, a.SliceQuery()), txh))
        mgr2.close()
        for p in range(3):
            if p != victim:
                nodes.stop(p)
        solo = manager(which, [nodes.hosts[victim]], rf=1)
        got2 = rows(solo.open_database("s").get_slice(
            a.KeySliceQuery(key, a.SliceQuery()), txh))
        solo.close()
        return got, got2
    assert run_both(scen) == ([(b"c", b"new")], [(b"c", b"new")])


def test_tombstones_prevent_deleted_data_resurrection():
    def scen(which, nodes):
        a = api(which)
        mgr = manager(which, nodes.hosts, rf=3, wc="quorum", read_repair=1.0)
        store = mgr.open_database("s")
        txh = mgr.begin_transaction()
        key = b"del-key"
        store.mutate(key, [a.Entry(b"c", b"live")], [], txh)
        victim = mgr.ring.replicas(key)[0]
        nodes.stop(victim)
        store.mutate(key, [], [b"c"], txh)
        mgr.close()
        nodes.restart(victim)
        mgr2 = manager(which, nodes.hosts, rf=3, wc="quorum",
                       read_repair=1.0)
        store2 = mgr2.open_database("s")
        got = rows(store2.get_slice(a.KeySliceQuery(key, a.SliceQuery()),
                                    txh))
        scanned = dict(store2.get_keys(a.KeyRangeQuery(
            key, key + b"\xff", a.SliceQuery()), txh))
        mgr2.close()
        return got, key in scanned
    assert run_both(scen) == ([], False)


def test_tombstone_compaction():
    def scen(which, nodes):
        a = api(which)
        errors = mod(which, "errors")
        mgr = manager(which, nodes.hosts, rf=2)
        store = mgr.open_database("s")
        txh = mgr.begin_transaction()
        for i in range(10):
            store.mutate(b"k%d" % i, [a.Entry(b"c", b"v")], [], txh)
        for i in range(10):
            store.mutate(b"k%d" % i, [], [b"c"], txh)
        purged = mgr.compact_tombstones(["s"], grace_seconds=0.0)
        after = [rows(store.get_slice(a.KeySliceQuery(
            b"k%d" % i, a.SliceQuery()), txh)) for i in range(10)]
        nodes.stop(0)
        with pytest.raises(errors.TemporaryBackendError):
            mgr.compact_tombstones(["s"])
        mgr.close()
        return purged, after
    purged, after = run_both(scen)
    assert purged == 20 and after == [[]] * 10     # rf 2: two a key


def test_concurrent_writers_converge():
    def scen(which, nodes):
        a = api(which)
        m1 = manager(which, nodes.hosts, rf=2, wc="quorum", read_repair=1.0)
        m2 = manager(which, nodes.hosts, rf=2, wc="quorum", read_repair=1.0)
        txh = m1.begin_transaction()

        def writer(mgr, who):
            s = mgr.open_database("s")
            for i in range(30):
                s.mutate(b"contended",
                         [a.Entry(b"c", b"%s-%d" % (who, i))], [], txh)
        ts = [threading.Thread(target=writer, args=(m, w))
              for m, w in ((m1, b"a"), (m2, b"b"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        q = a.KeySliceQuery(b"contended", a.SliceQuery())
        v1 = rows(m1.open_database("s").get_slice(q, txh))
        v2 = rows(m2.open_database("s").get_slice(q, txh))
        m1.close()
        m2.close()
        # which writer wins is the race's; that both agree is not
        return v1 == v2, len(v1), v1[0][1].endswith(b"-29")
    assert run_both(scen) == (True, 1, True)


def test_hint_overflow_forces_merged_reads_until_full_sync():
    def scen(which, nodes):
        a = api(which)
        mgr = manager(which, nodes.hosts, rf=3, wc="quorum", read_repair=0.0,
                      max_hints_per_peer=1)
        store = mgr.open_database("s")
        txh = mgr.begin_transaction()
        store.mutate(b"seed", [a.Entry(b"c", b"0")], [], txh)
        victim = mgr.ring.replicas(b"k0")[0]
        nodes.stop(victim)
        for i in range(4):
            store.mutate(b"k%d" % i, [a.Entry(b"c", b"v%d" % i)], [], txh)
        tainted = set(mgr._ever_overflowed) == {victim}
        nodes.restart(victim)
        up = mgr.is_up(victim)
        still = set(mgr._ever_overflowed) == {victim}
        forced = mgr.repair_roll()
        mgr.compact_tombstones(["s"])
        healed = mgr._ever_overflowed == set()
        mgr.close()
        for p in range(3):
            if p != victim:
                nodes.stop(p)
        solo = manager(which, [nodes.hosts[victim]], rf=1)
        s2 = solo.open_database("s")
        got = [rows(s2.get_slice(a.KeySliceQuery(b"k%d" % i,
                                                 a.SliceQuery()), txh))
               for i in range(4)]
        solo.close()
        return tainted, up, still, forced, healed, got
    assert run_both(scen) == (True, True, True, True, True,
                              [[(b"c", b"v%d" % i)] for i in range(4)])


def test_hint_replay_does_not_overwrite_newer_direct_write():
    def scen(which, nodes):
        a = api(which)
        mem = mod(which, "storage.inmemory").InMemoryStoreManager
        mgr = manager(which, nodes.hosts, rf=3, wc="quorum")
        store = mgr.open_database("e")
        txh = a.StoreTransaction(None)
        mgr.mark_down(1)
        nodes.stop(1)
        store.mutate(b"k", [a.Entry(b"c", b"old")], [], txh)
        revived = nodes.remote.KCVSServer(
            mem(), port=nodes.servers[1].port).start()
        try:
            store.mutate(b"k", [a.Entry(b"c", b"new")], [], txh)
            got = rows(store.get_slice(a.KeySliceQuery(
                b"k", a.SliceQuery(b"", b"\xff")), txh))
        finally:
            revived.stop()
        mgr.close()
        return got
    assert run_both(scen) == [(b"c", b"new")]


def test_the_repair_roll_follows_jax_sequence():
    """The manager's own seeded generator decides read repair: the same
    rolls in both packages."""
    def scen(which, nodes):
        mgr = manager(which, nodes.hosts, rf=2, read_repair=0.3)
        rolls = [mgr.repair_roll() for _ in range(200)]
        mgr.close()
        return rolls
    rolls = run_both(scen, count=2)
    assert 20 < sum(rolls) < 100


def test_auto_compaction_daemon():
    def scen(which, nodes):
        a = api(which)
        mgr = mod(which, "storage.cluster").ClusterStoreManager(
            nodes.hosts, replication=2, virtual_nodes=16)
        store = mgr.open_database("s")
        txh = mgr.begin_transaction()
        for i in range(8):
            store.mutate(b"a%d" % i, [a.Entry(b"c", b"v")], [], txh)
        for i in range(8):
            store.mutate(b"a%d" % i, [], [b"c"], txh)
        mgr.start_auto_compaction(0.2, grace_seconds=0.0)
        deadline = time.time() + 20
        while time.time() < deadline and \
                mgr.compaction_stats["purged"] < 16:
            time.sleep(0.05)
        purged = mgr.compaction_stats["purged"]
        gone = [rows(store.get_slice(a.KeySliceQuery(
            b"a%d" % i, a.SliceQuery()), txh)) for i in range(8)]
        nodes.stop(0)
        mgr.mark_down(0)
        skipped0 = mgr.compaction_stats["skipped"]
        deadline = time.time() + 20
        while time.time() < deadline and \
                mgr.compaction_stats["skipped"] <= skipped0:
            time.sleep(0.05)
        skipped = mgr.compaction_stats["skipped"] > skipped0
        err = "replica" in (mgr.compaction_stats["last_error"] or "")
        mgr.close()
        return purged, gone, skipped, err, mgr._compactor is None
    assert run_both(scen) == (16, [[]] * 8, True, True, True)


# -- graphs over the ring -----------------------------------------------------

def _cluster_config(nodes, **extra) -> dict:
    cfg = {"storage.backend": "remote-cluster",
           "storage.hostname": nodes.hosts,
           "storage.cluster.virtual-nodes": 16,
           "storage.lock.wait-time": 5, "ids.authority.wait-time": 5}
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("rf,wc", [(1, "all"), (2, "all"), (2, "quorum"),
                                   (2, "one"), (3, "quorum")])
def test_graph_over_cluster_equals_jax(rf, wc):
    """``open({"storage.backend": "remote-cluster", ...})`` at each
    replication factor and write consistency: twin graphs give the same
    ids, traversals and schema."""
    def scen(which, nodes):
        g = open_twin(which, config=_cluster_config(
            nodes, **{"storage.cluster.replication-factor": rf,
                      "storage.cluster.write-consistency": wc}))
        try:
            tx = g.new_transaction()
            a = tx.add_vertex("person", name="alice")
            b = tx.add_vertex("person", name="bob")
            c = tx.add_vertex("person", name="carol")
            tx.add_edge(a, "knows", b)
            tx.add_edge(a, "knows", c)
            tx.add_edge(c, "likes", b)
            tx.commit()
            out = sorted(g.traversal().V().has("name", "alice")
                         .out("knows").values("name").to_list())
            ids = canon(g.traversal().V().order().by("name").to_list())
            names = sorted(t.name for t in g.schema.all_types())
            return out, ids, names
        finally:
            g.close()
    out, ids, names = run_both(scen)
    assert out == ["bob", "carol"] and len(ids) == 3
    assert {"person", "name", "knows", "likes"} <= set(names)


def test_graph_survives_replica_failure():
    def scen(which, nodes):
        g = open_twin(which, config=_cluster_config(
            nodes, **{"storage.cluster.replication-factor": 3,
                      "storage.cluster.write-consistency": "quorum"}))
        try:
            tx = g.new_transaction()
            a = tx.add_vertex("person", name="alice")
            b = tx.add_vertex("person", name="bob")
            tx.add_edge(a, "knows", b)
            tx.commit()
            nodes.stop(1)
            first = g.traversal().V().has("name", "alice").out("knows") \
                .values("name").to_list()
            tx = g.new_transaction()
            c = tx.add_vertex("person", name="carol")
            tx.add_edge(tx.vertex(a.id), "knows", c)
            tx.commit()
            g.tx().rollback()
            second = sorted(g.traversal().V().has("name", "alice")
                            .out("knows").values("name").to_list())
            return first, second
        finally:
            g.close()
    assert run_both(scen) == (["bob"], ["bob", "carol"])


def test_auto_compaction_config_wiring():
    def scen(which, nodes):
        pkg = importlib.import_module(ROOT[which])
        g = pkg.open(_cluster_config(nodes, **{
            "storage.cluster.replication-factor": 2,
            "storage.cluster.compaction-interval-s": 0.5,
            "storage.cluster.gc-grace-seconds": 0.0}))
        try:
            raw = g.backend.manager
            while not hasattr(raw, "start_auto_compaction"):
                raw = raw.manager if hasattr(raw, "manager") else raw.inner
            return type(raw).__name__, raw._compactor is not None
        finally:
            g.close()
    assert run_both(scen) == ("ClusterStoreManager", True)


def test_a_port_graph_over_jax_nodes_reads_like_jax():
    """A port graph and a JAX graph mounted on the same JAX nodes: what
    one commits, the other reads."""
    nodes = Nodes("jax", 3)
    try:
        cfg = _cluster_config(nodes, **{
            "storage.cluster.replication-factor": 2})
        gp = open_twin("port", config=dict(cfg))
        tx = gp.new_transaction()
        a = tx.add_vertex("person", name="ann")
        tx.add_edge(a, "knows", tx.add_vertex("person", name="ben"))
        tx.commit()
        gp.close()
        gj = importlib.import_module("titan_tpu").open(dict(cfg))
        try:
            assert gj.traversal().V(a.id).out("knows").values("name") \
                .to_list() == ["ben"]
        finally:
            gj.close()
    finally:
        nodes.close()


def test_a_jax_store_path_is_refused_before_import():
    from titan_tpu_torch.storage.registry import store_manager
    for path in ("titan_tpu.storage.inmemory.InMemoryStoreManager",
                 "titan_tpu.no_such_module.Store", "jax.Store"):
        with pytest.raises(ValueError, match="never imports"):
            store_manager(path)
    assert type(store_manager(
        "titan_tpu_torch.storage.inmemory.InMemoryStoreManager")).__name__ \
        == "InMemoryStoreManager"
