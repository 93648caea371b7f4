"""``metrics.enabled`` on the port (titan_tpu_torch.utils.metrics: the
instrumented stores and the scheduled reporters) against the JAX
package's: on twin graphs the store and transaction counters and timer
counts are equal, name for name; the console, CSV and Graphite emitters
write the JAX package's text for the same registry; a shared reporter is
refcounted as the JAX package's is; and the graph wires the instrumented
manager under the store cache and the reporters from its config."""

import csv
import io
import socket
import threading
import time

import pytest

import titan_tpu
import titan_tpu_torch
from titan_tpu.ids.placement import SimpleBulkPlacement as JPlace
from titan_tpu.storage.inmemory import InMemoryStoreManager as JMem
from titan_tpu.utils import metrics as JM
from titan_tpu_torch.ids.placement import SimpleBulkPlacement as PPlace
from titan_tpu_torch.storage.api import Entry, KeySliceQuery, SliceQuery
from titan_tpu_torch.storage.cache import ExpirationStoreCache
from titan_tpu_torch.storage.inmemory import InMemoryStoreManager as PMem
from titan_tpu_torch.utils import metrics as PM

PKGS = {"jax": (titan_tpu, JPlace, JM), "port": (titan_tpu_torch, PPlace, PM)}
FAST = {"storage.lock.wait-time": 5, "ids.authority.wait-time": 5}


@pytest.fixture
def fresh_registries():
    """Each package's process-global registry, emptied around the test."""
    for _, _, m in PKGS.values():
        m.MetricManager.instance().reset()
    yield {w: m.MetricManager.instance() for w, (_, _, m) in PKGS.items()}
    for _, _, m in PKGS.values():
        m.MetricManager.instance().reset()


def metered_twin(which, **extra):
    pkg, place, _ = PKGS[which]
    g = pkg.open({"storage.backend": "inmemory", "metrics.enabled": True,
                  **FAST, **extra})
    g.id_assigner.placement = place(g.idm.num_partitions, batch_size=5,
                                    seed=11)
    return g


def workload(g) -> None:
    """Writes, point reads, a traversal, a rollback."""
    tx = g.new_transaction()
    vs = [tx.add_vertex("person", name=f"p{i}", age=i) for i in range(12)]
    for a, b in zip(vs, vs[1:]):
        a.add_edge("knows", b)
    tx.commit()
    vids = [v.id for v in vs]
    tx = g.new_transaction()
    for vid in vids[::3]:
        v = tx.vertex(vid)
        v.value("name")
        list(v.out("knows"))
    tx.commit()
    assert g.traversal().V().out("knows").count().next() == 11
    g.new_transaction().rollback()


def counts(snapshot) -> dict:
    """The registry's counters and timer counts (timer times vary)."""
    return {k: v["count"] for k, v in snapshot.items()}


def test_twin_graphs_count_the_same_ops(fresh_registries):
    gs = {w: metered_twin(w) for w in PKGS}
    try:
        for g in gs.values():
            workload(g)
        want = counts(fresh_registries["jax"].snapshot())
        got = counts(fresh_registries["port"].snapshot())
    finally:
        for g in gs.values():
            g.close()
    assert got == want
    base = f"titan_tpu.{PM.MERGED_STORE}"
    assert got[f"{base}.getSlice.calls"] > 0
    assert got[f"{base}.mutateMany.calls"] == 1
    assert got["titan_tpu.tx.commit"] == 2
    assert got["titan_tpu.tx.rollback"] == 1
    assert got[f"{base}.getSlice.time"] == got[f"{base}.getSlice.calls"]


def test_the_prefix_and_the_store_layering(fresh_registries):
    g = metered_twin("port", **{"metrics.prefix": "t",
                                "cache.db-cache": True})
    try:
        assert isinstance(g.backend.manager,
                          PM.MetricInstrumentedStoreManager)
        assert isinstance(g.backend.manager.wrapped, PMem)
        store = g.backend.edge_store
        assert isinstance(store, ExpirationStoreCache)
        assert isinstance(store.store, PM.MetricInstrumentedStore)
        workload(g)
    finally:
        g.close()
    m = fresh_registries["port"]
    assert m.counter_value("t.tx.begin") > 0
    assert m.counter_value(f"t.{PM.MERGED_STORE}.mutateMany.calls") == 1
    assert not [k for k in m.snapshot() if k.startswith("titan_tpu.")]


@pytest.mark.parametrize("which", ["jax", "port"])
def test_instrumented_store_counts_ops_and_exceptions(which):
    mod = PKGS[which][2]
    mem = (JMem if which == "jax" else PMem)()
    m = mod.MetricManager()
    mgr = mod.MetricInstrumentedStoreManager(mem, "p", metrics=m)
    api = __import__(f"{'titan_tpu' if which == 'jax' else 'titan_tpu_torch'}"
                     ".storage.api", fromlist=["Entry"])
    store = mgr.open_database("s")
    txh = mgr.begin_transaction()
    store.mutate(b"k", [api.Entry(b"c", b"v"), api.Entry(b"d", b"w")], [],
                 txh)
    assert len(store.get_slice(api.KeySliceQuery(b"k", api.SliceQuery()),
                               txh)) == 2
    store.get_slice(api.KeySliceQuery(b"nope", api.SliceQuery()), txh)
    store.get_slice_multi([b"k"], api.SliceQuery(), txh)
    list(store.get_keys(api.SliceQuery(), txh))
    with pytest.raises(NotImplementedError):
        store.acquire_lock(b"k", b"c", None, txh)
    base = f"p.{mod.MERGED_STORE}"
    assert m.counter_value(f"{base}.mutate.calls") == 1
    assert m.counter_value(f"{base}.getSlice.calls") == 2
    assert m.counter_value(f"{base}.getSlice.entries-returned") == 2
    assert m.timer_count(f"{base}.getSlice.time") == 2
    assert m.counter_value(f"{base}.getSliceMulti.calls") == 1
    assert m.counter_value(f"{base}.getKeys.calls") == 1
    assert m.counter_value(f"{base}.acquireLock.exceptions") == 1
    assert store.name == "s" and store.wrapped is mem.open_database("s")


def test_unmerged_names_and_the_same_counts_as_jax():
    out = {}
    for which in PKGS:
        mod = PKGS[which][2]
        api = __import__(f"{'titan_tpu' if which == 'jax' else 'titan_tpu_torch'}"
                         ".storage.api", fromlist=["Entry"])
        m = mod.MetricManager()
        mem = (JMem if which == "jax" else PMem)()
        mgr = mod.MetricInstrumentedStoreManager(mem, "q", metrics=m,
                                                 merge_stores=False)
        store = mgr.open_database("edges")
        txh = mgr.begin_transaction()
        store.mutate(b"a", [api.Entry(b"c", b"v")], [], txh)
        mgr.mutate_many({}, txh)
        store.get_slice(api.KeySliceQuery(b"a", api.SliceQuery()), txh)
        out[which] = counts(m.snapshot())
    assert out["port"] == out["jax"]
    assert "q.edges.mutate.calls" in out["port"]


def _registry(mod):
    m = mod.MetricManager()
    m.counter("reads").inc(3)
    m.counter("ops").inc(5)
    m.timer("lat").update(2_000_000)
    m.timer("lat").update(4_000_000)
    h = m.histogram("sizes")
    for x in (1.0, 2.0, 3.0, 10.0):
        h.update(x)
    return m


def test_console_and_csv_emitters_write_the_jax_text(tmp_path):
    text = {}
    for which in PKGS:
        mod = PKGS[which][2]
        buf = io.StringIO()
        mod._console_emit(buf)(_registry(mod), 1700000000.25)
        d = tmp_path / which
        mod._csv_emit(str(d))(_registry(mod), 1700000000.25)
        mod._csv_emit(str(d))(_registry(mod), 1700000001.5)
        text[which] = (buf.getvalue(), (d / "metrics.csv").read_text())
    assert text["port"] == text["jax"]
    assert "ops: 5" in text["port"][0]
    rows = list(csv.reader(io.StringIO(text["port"][1])))
    assert rows[0][0] == "timestamp" and len(rows) == 1 + 2 * 4


def _graphite_lines(mod) -> str:
    got: list[bytes] = []
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    port = srv.getsockname()[1]

    def accept():
        c, _ = srv.accept()
        with c:
            while chunk := c.recv(65536):
                got.append(chunk)

    t = threading.Thread(target=accept, daemon=True)
    t.start()
    try:
        mod._graphite_emit("127.0.0.1", port, "tt")(_registry(mod),
                                                    1700000000.9)
        t.join(10)
    finally:
        srv.close()
    return b"".join(got).decode()


def test_graphite_emitter_sends_the_jax_lines():
    want, got = _graphite_lines(JM), _graphite_lines(PM)
    assert got == want
    assert "tt.ops 5 1700000000\n" in got


def test_scheduled_reporter_reports_and_stops():
    m = _registry(PM)
    buf = io.StringIO()
    r = PM.ScheduledReporter(m, 0.05, PM._console_emit(buf), "console")
    try:
        deadline = time.time() + 5.0
        while r.reports < 2 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        r.stop()
    assert r.reports >= 2 and r.errors == 0 and r.stopped
    r.report_now()                       # after stop: a no-op
    n = r.reports
    r.report_now()
    assert r.reports == n

    def boom(manager, ts):
        raise OSError("dead sink")

    r = PM.ScheduledReporter(m, 0.02, boom, "bad")
    try:
        deadline = time.time() + 5.0
        while r.errors < 1 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        r.stop()
    assert r.errors >= 1 and r.reports == 0


def test_start_reporters_share_and_refcount():
    """tests/test_metrics.py's dedup case on the port: one reporter per
    (manager, sink); the last stop ends it and evicts it."""
    from titan_tpu_torch.config import defaults as d

    class _Cfg:
        def get(self, opt, *a):
            if opt is d.METRICS_CONSOLE_INTERVAL:
                return 300.0
            if opt is d.METRICS_PREFIX:
                return "tt"
            return 0

    m, m2, cfg = PM.MetricManager(), PM.MetricManager(), _Cfg()
    r1, r2, r3 = (PM.start_reporters(cfg, m), PM.start_reporters(cfg, m),
                  PM.start_reporters(cfg, m2))
    try:
        assert len(r1) == len(r2) == 1 and r1[0] is r2[0]
        assert r3[0] is not r1[0]
        assert r1[0]._refs == 2
        r1[0].stop()
        assert not r1[0].stopped and r1[0]._refs == 1
        r2[0].stop()
        assert r2[0].stopped
        assert r1[0] not in PM._ACTIVE_REPORTERS.values()
        r4 = PM.start_reporters(cfg, m)
        assert r4[0] is not r1[0] and not r4[0].stopped
        r4[0].stop()
    finally:
        r3[0].stop()
    assert PM._ACTIVE_REPORTERS is not JM._ACTIVE_REPORTERS


def test_graph_wires_a_csv_reporter_and_stops_it(tmp_path,
                                                 fresh_registries):
    d = str(tmp_path / "csvdir")
    extra = {"metrics.csv.interval-s": 0.05, "metrics.csv.directory": d}
    g = metered_twin("port", **extra)
    g2 = metered_twin("port", **extra)
    try:
        assert g._reporters[0] is g2._reporters[0]
        workload(g)
        # two reports after the workload: the second began after it ended
        want = g._reporters[0].reports + 2
        deadline = time.time() + 30.0
        while g._reporters[0].reports < want and time.time() < deadline:
            time.sleep(0.02)
        assert g._reporters[0].reports >= want
    finally:
        g.close()
        assert not g2._reporters[0].stopped
        g2.close()
    assert g._reporters[0].stopped
    assert not g._reporters[0]._thread.is_alive()
    rows = list(csv.reader(open(d + "/metrics.csv")))
    assert rows[0] == ["timestamp", "metric", "count", "mean_ms", "min_ms",
                       "max_ms"]
    assert any(r[1] == "titan_tpu.tx.commit" for r in rows[1:])


def test_an_unmetered_graph_counts_nothing(fresh_registries):
    g = titan_tpu_torch.open({"storage.backend": "inmemory", **FAST})
    try:
        workload(g)
        assert g._metrics is None and g._reporters == []
        assert not isinstance(g.backend.manager,
                              PM.MetricInstrumentedStoreManager)
    finally:
        g.close()
    assert fresh_registries["port"].snapshot() == {}


def test_port_instance_is_its_own(fresh_registries):
    assert fresh_registries["port"] is not fresh_registries["jax"]
    e = Entry(b"c", b"v")
    assert isinstance(e, tuple) and KeySliceQuery(b"k", SliceQuery())


@pytest.mark.parametrize("which", ["jax", "port"])
def test_snapshot_takes_the_registry_lock(which, fresh_registries):
    """A reporter thread snapshots while the graph's threads add names.
    The port lists the registry under the lock that guards insertion;
    the JAX package's snapshot iterates the live dicts without it, so a
    name added mid-iteration raises in the reporter (ROADMAP queue 3)."""
    m = fresh_registries[which]
    m.counter("a").inc()
    done = threading.Event()
    t = threading.Thread(target=lambda: (m.snapshot(), done.set()))
    with m._lock:
        t.start()
        waited = not done.wait(0.2)
    t.join(5.0)
    assert done.is_set()
    assert waited == (which == "port")
