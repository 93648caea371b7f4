"""The port's HTTP scan workers (``titan_tpu_torch/olap/scan_worker.py``)
against the JAX package's: ``RemoteScanRunner`` over two workers and a
``remote-cluster`` store at replication 2, failover, the job-fault path,
the allowlist and the bearer token, the scan metrics, the stitched trace
(span names and counts), the observation endpoints, and REINDEX over the
workers; every scenario in both packages, counts exact. Across the
packages a port worker refuses a JAX coordinator's factory before it
imports anything."""

import importlib
import json
import sys

import numpy as np
import pytest

ROOT = {"jax": "titan_tpu", "port": "titan_tpu_torch"}
BOTH = ("jax", "port")


def mod(which: str, name: str):
    return importlib.import_module(f"{ROOT[which]}.{name}")


class Cluster:
    """Two storage nodes (replication 2) and two scan workers of one
    package."""

    def __init__(self, which: str, workers: int = 2, **worker_kw):
        remote = mod(which, "storage.remote")
        mem = mod(which, "storage.inmemory").InMemoryStoreManager
        sw = mod(which, "olap.scan_worker")
        self.which = which
        self.storage = [remote.KCVSServer(mem()).start() for _ in range(2)]
        self.cfg = {"storage.backend": "remote-cluster",
                    "storage.hostname": [f"127.0.0.1:{s.port}"
                                         for s in self.storage],
                    "storage.cluster.replication-factor": 2}
        self.workers = [sw.ScanWorkerServer(**worker_kw).start()
                        for _ in range(workers)]

    @property
    def urls(self) -> list:
        return [f"127.0.0.1:{w.port}" for w in self.workers]

    def close(self) -> None:
        for node in self.workers + self.storage:
            node.stop()


def populate(which, cfg, n_people=30, n_edges=45):
    g = importlib.import_module(ROOT[which]).open(dict(cfg))
    tx = g.new_transaction()
    people = [tx.add_vertex("person", name=f"p{i}")
              for i in range(n_people)]
    rng = np.random.default_rng(3)
    for _ in range(n_edges):
        a, b = rng.integers(0, n_people, 2)
        people[int(a)].add_edge("knows", people[int(b)])
    tx.commit()
    g.close()


def spec(which):
    return mod(which, "olap.distributed").ScanJobSpec(
        f"{ROOT[which]}.olap.jobs:make_vertex_count_job")


def counts(m) -> dict:
    return {"v": m.get("vertex-count"), "e": m.get("edge-count")}


def run_both(scenario, **kw):
    got = {}
    for which in BOTH:
        c = Cluster(which, **kw)
        try:
            got[which] = scenario(which, c)
        finally:
            c.close()
    assert got["port"] == got["jax"]
    return got["port"]


def dead_worker(which) -> str:
    w = mod(which, "olap.scan_worker").ScanWorkerServer().start()
    addr = f"127.0.0.1:{w.port}"
    w.stop()
    return addr


# -- scans over the workers ---------------------------------------------------

def test_remote_workers_scan_cluster_backend():
    def scen(which, c):
        populate(which, c.cfg)
        runner = mod(which, "olap.scan_worker").RemoteScanRunner(c.urls,
                                                                 c.cfg)
        return counts(runner.run(spec(which)))
    assert run_both(scen) == {"v": 30, "e": 45}


@pytest.mark.parametrize("per_worker", [1, 3])
def test_worker_failover_requeues_splits(per_worker):
    def scen(which, c):
        populate(which, c.cfg, n_people=20, n_edges=10)
        runner = mod(which, "olap.scan_worker").RemoteScanRunner(
            [dead_worker(which), c.urls[1]], c.cfg,
            splits_per_worker=per_worker)
        return counts(runner.run(spec(which)))
    assert run_both(scen) == {"v": 20, "e": 10}


def test_requeued_split_reaches_idle_worker():
    def scen(which, c):
        populate(which, c.cfg, n_people=12, n_edges=6)
        runner = mod(which, "olap.scan_worker").RemoteScanRunner(
            [c.urls[0], dead_worker(which)], c.cfg, splits_per_worker=1)
        return counts(runner.run(spec(which)))
    assert run_both(scen) == {"v": 12, "e": 6}


def test_all_workers_dead_raises():
    def scen(which, c):
        populate(which, c.cfg, n_people=2, n_edges=0)
        runner = mod(which, "olap.scan_worker").RemoteScanRunner(
            [dead_worker(which)], c.cfg)
        with pytest.raises(mod(which, "errors").TemporaryBackendError,
                           match="undispatchable"):
            runner.run(spec(which))
        return True
    run_both(scen)


def test_bad_job_spec_fails_fast_as_permanent():
    def scen(which, c):
        populate(which, c.cfg, n_people=2, n_edges=0)
        runner = mod(which, "olap.scan_worker").RemoteScanRunner(c.urls,
                                                                 c.cfg)
        ScanJobSpec = mod(which, "olap.distributed").ScanJobSpec
        with pytest.raises(mod(which, "errors").PermanentBackendError):
            runner.run(ScanJobSpec(f"{ROOT[which]}.no_such_module:nope"))
        return True
    run_both(scen)


def test_scan_results_equal_with_propagation_on_and_off():
    def scen(which, c):
        populate(which, c.cfg)
        sw = mod(which, "olap.scan_worker")
        tracing = mod(which, "obs.tracing")
        MM = mod(which, "utils.metrics").MetricManager
        on = sw.RemoteScanRunner(c.urls, c.cfg, metrics=MM(),
                                 tracer=tracing.Tracer(),
                                 propagate=True).run(spec(which))
        off_tracer = tracing.Tracer()
        off = sw.RemoteScanRunner(c.urls, c.cfg, metrics=MM(),
                                  tracer=off_tracer,
                                  propagate=False).run(spec(which))
        bare = sw.RemoteScanRunner(c.urls, c.cfg,
                                   metrics=MM()).run(spec(which))
        assert on._counts == off._counts == bare._counts
        assert all(not (s.attrs or {}).get("remote")
                   for s in off_tracer.spans("scan"))
        return counts(on)
    assert run_both(scen) == {"v": 30, "e": 45}


# -- metrics and the stitched trace --------------------------------------------

def test_scan_metrics_and_spans_on_failover():
    def scen(which, c):
        populate(which, c.cfg, n_people=18, n_edges=9)
        sw = mod(which, "olap.scan_worker")
        m = mod(which, "utils.metrics").MetricManager()
        live = sw.ScanWorkerServer(metrics=m).start()
        dead = dead_worker(which)
        tracer = mod(which, "obs.tracing").Tracer()
        try:
            got = sw.RemoteScanRunner(
                [dead, f"127.0.0.1:{live.port}"], c.cfg,
                splits_per_worker=2, metrics=m, tracer=tracer).run(
                spec(which))
        finally:
            live.stop()
        spans = tracer.spans("scan")
        local = [s for s in spans if not (s.attrs or {}).get("remote")]
        remote = [s for s in spans if (s.attrs or {}).get("remote")]
        return (counts(got),
                [m.counter_value(f"scan.remote.{k}") for k in (
                    "splits_merged", "splits_served",
                    "splits_redispatched", "splits_dispatched")],
                m.counter_value("scan.remote.worker_failures",
                                labels={"url": f"http://{dead}"}),
                sorted((s.name, bool(s.attrs.get("redispatched")),
                        bool(s.attrs.get("ok"))) for s in local),
                sorted(s.name for s in remote),
                {s.attrs["instance"] for s in remote}
                == {f"http://127.0.0.1:{live.port}"})
    got = run_both(scen)
    assert got[:3] == ({"v": 18, "e": 9}, [4, 4, 1, 5], 1)
    assert got[3] == [("split", False, True)] * 4 + [("split", True, False)]
    assert got[4] == ["execute"] * 4 + ["serialize"] * 4 + ["split"] * 4
    assert got[5] is True


def test_distributed_scan_yields_one_stitched_trace():
    """bench.py's ``distributed_scan_stage``: one tree, each coordinator
    split carrying the worker's split with execute and serialize, nested
    in time; the span names and counts equal JAX's."""
    def scen(which, c):
        populate(which, c.cfg, n_people=24, n_edges=12)
        sw = mod(which, "olap.scan_worker")
        m = mod(which, "utils.metrics").MetricManager()
        tracer = mod(which, "obs.tracing").Tracer()
        got = sw.RemoteScanRunner(c.urls, c.cfg, metrics=m, tracer=tracer,
                                  trace_id="scan-job-1").run(spec(which))
        tree = tracer.tree("scan-job-1")
        shape, instances = [], set()

        def nested(parent, node):
            assert parent["start"] <= node["start"] <= node["end"] \
                <= parent["end"], (parent["name"], node["name"])
            for ch in node["children"]:
                nested(node, ch)
        for coord in tree["spans"]:
            assert "remote" not in (coord.get("attrs") or {})
            [wroot] = coord["children"]
            instances.add(wroot["attrs"]["instance"])
            nested(coord, wroot)
            shape.append((coord["name"], wroot["name"],
                          wroot["attrs"]["remote"],
                          sorted(ch["name"] for ch in wroot["children"])))
        return (counts(got), tree["trace"], sorted(shape), len(instances),
                m.counter_value("obs.ingest.spans"),
                m.counter_value("obs.ingest.dropped"))
    got = run_both(scen)
    assert got[0] == {"v": 24, "e": 12} and got[1] == "scan-job-1"
    assert got[2] == [("split", "split", True,
                       ["execute", "serialize"])] * 4
    assert got[3:] == (2, 12, 0)


def test_worker_failure_label_cardinality_is_bounded():
    got = {}
    for which in BOTH:
        MM = mod(which, "utils.metrics").MetricManager
        m = MM()
        n_urls = MM.MAX_CHILDREN + 44
        for i in range(n_urls):
            m.counter("scan.remote.worker_failures",
                      labels={"url": f"http://10.0.0.{i}:9{i:03d}"}).inc()
        got[which] = (len(m.children("scan.remote.worker_failures")),
                      m.counter_value("scan.remote.worker_failures"),
                      m.counter_value(MM.LABELS_DROPPED), MM.MAX_CHILDREN)
    assert got["port"] == got["jax"]
    assert got["port"][0] == got["port"][3] and got["port"][2] == 44


# -- the worker's own surface ---------------------------------------------------

def test_worker_get_metrics_and_healthz():
    got = {}
    for which in BOTH:
        m = mod(which, "utils.metrics").MetricManager()
        m.counter("scan.remote.splits_served").inc(7)
        w = mod(which, "olap.scan_worker").ScanWorkerServer(
            metrics=m).start()
        try:
            text_get = mod(which, "utils.httpnode").text_get
            body = text_get(w.url, "/metrics")
            got[which] = ("scan_remote_splits_served 7" in body,
                          json.loads(text_get(w.url, "/healthz")))
        finally:
            w.stop()
    assert got["port"] == got["jax"]
    assert got["port"] == (True, {"live": True, "ready": True,
                                  "role": "scan-worker",
                                  "splits_served": 7})


def test_worker_trace_drain_endpoint_is_bounded():
    got = {}
    for which in BOTH:
        w = mod(which, "olap.scan_worker").ScanWorkerServer().start()
        cap = mod(which, "obs.tracing").INGEST_MAX_SPANS
        call = mod(which, "utils.httpnode").json_call
        try:
            for i in range(5):
                w.tracer.event("bg", f"tick{i}")
            a = call(w.url, "/trace/drain", {"trace": "bg", "max_spans": 3})
            b = call(w.url, "/trace/drain",
                     {"trace": "bg", "max_spans": cap * 9})
            c = call(w.url, "/trace/drain", {"trace": "bg"})
            got[which] = ([s["name"] for s in a["spans"]],
                          [s["name"] for s in b["spans"]], c["spans"], cap)
        finally:
            w.stop()
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (["tick0", "tick1", "tick2"],
                               ["tick3", "tick4"], [])


def test_worker_bearer_token_gate():
    for which in BOTH:
        w = mod(which, "olap.scan_worker").ScanWorkerServer(
            auth_token="s3cret").start()
        call = mod(which, "utils.httpnode").json_call
        try:
            with pytest.raises(mod(which, "errors").PermanentBackendError,
                               match="bearer"):
                call(w.url, "/ping", {})
            assert call(w.url, "/ping", {}, token="s3cret") == {"ok": True}
        finally:
            w.stop()


def test_the_allowlist_is_dot_anchored_and_the_port_s_own():
    for which in BOTH:
        w = mod(which, "olap.scan_worker").ScanWorkerServer(
            factory_allow=["myjobs", f"{ROOT[which]}."])
        assert w._factory_allowed("myjobs:job")
        assert w._factory_allowed("myjobs.sub:job")
        assert w._factory_allowed(f"{ROOT[which]}.olap.jobs:x")
        assert not w._factory_allowed("myjobs_evil:job")
        assert not w._factory_allowed(f"{ROOT[which]}_evil.mod:job")
        assert not w._factory_allowed("os:system")
    port = mod("port", "olap.scan_worker").ScanWorkerServer()
    assert port.factory_allow == ["titan_tpu_torch."]
    assert not port._factory_allowed("titan_tpu.olap.jobs:x")
    jax = mod("jax", "olap.scan_worker").ScanWorkerServer()
    assert not jax._factory_allowed("titan_tpu_torch.olap.jobs:x")


@pytest.mark.parametrize("which", BOTH)
def test_worker_rejects_an_unlisted_factory(which):
    w = mod(which, "olap.scan_worker").ScanWorkerServer().start()
    try:
        with pytest.raises(mod(which, "errors").PermanentBackendError,
                           match="allowlist"):
            mod(which, "utils.httpnode").json_call(w.url, "/scan", {
                "factory": "os:system", "kwargs": {}, "graph_config": {},
                "key_start": "", "key_end": ""})
    finally:
        w.stop()


# -- across the packages ----------------------------------------------------------

def test_a_jax_coordinator_s_factory_is_a_job_fault_on_port_workers():
    """A JAX ``RemoteScanRunner`` over port workers: the worker refuses
    ``titan_tpu.`` by its allowlist, a permanent fault, not a retry."""
    c = Cluster("port")
    try:
        populate("port", c.cfg, n_people=3, n_edges=0)
        runner = mod("jax", "olap.scan_worker").RemoteScanRunner(c.urls,
                                                                 c.cfg)
        with pytest.raises(mod("jax", "errors").PermanentBackendError,
                           match="allowlist"):
            runner.run(spec("jax"))
    finally:
        c.close()


def test_an_extended_allowlist_still_never_imports_jax(monkeypatch):
    """With ``titan_tpu.`` admitted through TITAN_TPU_SCAN_FACTORIES the
    port worker still refuses the factory, before any import: a module
    that does not exist fails as the refusal, not as ModuleNotFoundError."""
    monkeypatch.setenv("TITAN_TPU_SCAN_FACTORIES", "titan_tpu.")
    c = Cluster("port")
    try:
        populate("port", c.cfg, n_people=3, n_edges=0)
        assert c.workers[0].factory_allow == ["titan_tpu_torch.",
                                              "titan_tpu."]
        ScanJobSpec = mod("port", "olap.distributed").ScanJobSpec
        runner = mod("port", "olap.scan_worker").RemoteScanRunner(c.urls,
                                                                  c.cfg)
        with pytest.raises(mod("port", "errors").PermanentBackendError,
                           match="never imports"):
            runner.run(ScanJobSpec("titan_tpu.no_such_module:job"))
        assert "titan_tpu.no_such_module" not in sys.modules
    finally:
        c.close()


def test_port_workers_scan_a_ring_of_jax_nodes():
    """Port workers open their graphs over the JAX package's storage
    nodes (the ring's wire is the remote store's) and count what a JAX
    graph wrote."""
    remote = mod("jax", "storage.remote")
    mem = mod("jax", "storage.inmemory").InMemoryStoreManager
    storage = [remote.KCVSServer(mem()).start() for _ in range(2)]
    workers = [mod("port", "olap.scan_worker").ScanWorkerServer().start()
               for _ in range(2)]
    try:
        cfg = {"storage.backend": "remote-cluster",
               "storage.hostname": [f"127.0.0.1:{s.port}" for s in storage],
               "storage.cluster.replication-factor": 2}
        populate("jax", cfg, n_people=10, n_edges=7)
        got = mod("port", "olap.scan_worker").RemoteScanRunner(
            [f"127.0.0.1:{w.port}" for w in workers], cfg).run(spec("port"))
        assert counts(got) == {"v": 10, "e": 7}
    finally:
        for n in workers + storage:
            n.stop()


# -- REINDEX over the workers -------------------------------------------------------

def test_distributed_reindex_over_remote_workers():
    def scen(which, c):
        pkg = importlib.import_module(ROOT[which])
        g = pkg.open(dict(c.cfg))
        tx = g.new_transaction()
        for i in range(15):
            tx.add_vertex("person", name=f"r{i}")
        tx.commit()
        mgmt = g.management()
        mgmt.build_index("byNameRemote", "vertex").add_key(
            g.schema.get_by_name("name")).build_composite_index()
        mgmt.update_index("byNameRemote", "register")
        g.close()
        m = mod(which, "olap.scan_worker").distributed_reindex_remote(
            c.urls, c.cfg, "byNameRemote")
        g2 = pkg.open(dict(c.cfg))
        g2.management().update_index("byNameRemote", "enable")
        got = [v.value("name") for v in
               g2.traversal().V().has("name", "r7").to_list()]
        g2.close()
        return m.get("index-entries-added"), got
    assert run_both(scen) == (15, ["r7"])
