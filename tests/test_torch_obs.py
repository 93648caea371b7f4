"""The port's observability plane and metrics registry
(``titan_tpu_torch/obs``, ``titan_tpu_torch/utils/metrics.py``) against
the JAX package's: the same calls on both give the same registry
snapshots, span trees, bundles, SLO reports and controller journals
(fake clocks, no wall-clock assertions). Then the port's own device
profiler (``obs/devprof``, rewritten for CUDA): results bit-equal with
profiling on and off, exec children per kernel seam, the transfer sites
and the build accounting, here on the CPU path."""

import json
import shutil
import threading

import numpy as np
import pytest
import torch

import titan_tpu.obs.flightrec as JFR
import titan_tpu.obs.slo as JSLO
import titan_tpu.obs.tracing as JTR
import titan_tpu.olap.serving.autotune as JAT
import titan_tpu.olap.serving.tenants as JTEN
import titan_tpu.utils.metrics as JM
import titan_tpu_torch.obs.flightrec as PFR
import titan_tpu_torch.obs.slo as PSLO
import titan_tpu_torch.obs.tracing as PTR
import titan_tpu_torch.olap.serving.autotune as PAT
import titan_tpu_torch.olap.serving.tenants as PTEN
import titan_tpu_torch.utils.metrics as PM
from titan_tpu_torch import build
from titan_tpu_torch.models import bfs_hybrid as P
from titan_tpu_torch.obs import devprof
from titan_tpu_torch.olap import engine as E
from titan_tpu_torch.olap import snapshot as SN

JAX = {"metrics": JM, "tracing": JTR, "flightrec": JFR, "slo": JSLO,
       "autotune": JAT, "tenants": JTEN}
PORT = {"metrics": PM, "tracing": PTR, "flightrec": PFR, "slo": PSLO,
        "autotune": PAT, "tenants": PTEN}


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _both(fn):
    """``fn(modules)`` on the JAX package's modules and the port's;
    asserts the two results are equal and returns the port's."""
    j, p = fn(JAX), fn(PORT)
    assert p == j
    return p


# --------------------------------------------------------------------------
# utils/metrics: the registry
# --------------------------------------------------------------------------

def _registry_workload(mod):
    m = mod["metrics"].MetricManager()
    m.counter("serving.jobs.completed",
              labels={"kind": "bfs", "tenant": "a"}).inc(3)
    m.counter("serving.jobs.completed",
              labels={"tenant": "b", "kind": "sssp"}).inc()
    m.counter("serving.queue.depth", gauge=True).inc(2)
    m.counter("serving.queue.depth", labels={"priority": "1"}).inc(-1)
    t = m.timer("t")
    for ns in (5_000_000, 1_000_000, 3_000_000):
        t.update(ns)
    h = m.histogram("serving.job.latency_ms", seed=7)
    for x in range(3000):                 # past the reservoir: sampled
        h.update(float((x * 37) % 1001))
    m.histogram("serving.batch.occupancy").update(16.0)
    m.gauge("serving.hbm.resident_bytes", lambda: 1234)
    m.gauge("serving.slo.burn_rate", labels={"slo": "x"}).set(2.5)
    return {"snapshot": m.snapshot(), "labeled": m.labeled(),
            "gauges": m.gauge_snapshot(),
            "gauge_counters": m.gauge_counters(),
            "tenant_a": m.counter_value("serving.jobs.completed",
                                        {"tenant": "a"}),
            "p95": h.percentile(95), "console": m.report_console(),
            "children": m.children("serving.jobs.completed",
                                   {"kind": "bfs"})[0][0],
            "hist_stats": m.histogram_stats("serving.batch.occupancy"),
            "absent": m.histogram_stats("nope")}


def test_registry_snapshots_equal_the_jax_registry():
    out = _both(_registry_workload)
    assert out["snapshot"]["serving.jobs.completed"]["count"] == 4
    assert out["tenant_a"] == 3
    assert out["gauges"]["serving.hbm.resident_bytes"]["value"] == 1234.0
    assert out["absent"] is None


def test_nearest_rank_and_csv(tmp_path):
    for q in (0.0, 0.5, 0.95, 1.0):
        xs = [5.0, 1.0, 9.0, 3.0, 7.0]
        assert PM.nearest_rank(xs, q) == JM.nearest_rank(xs, q)
    assert PM.nearest_rank([], 0.5) == 0.0
    texts = []
    for mod, name in ((JM, "j.csv"), (PM, "p.csv")):
        m = mod.MetricManager()
        m.counter("c").inc(2)
        m.histogram("h").update(4.0)
        m.timer("t").update(2_000_000)
        m.report_csv(str(tmp_path / name))
        texts.append((tmp_path / name).read_text())
    assert texts[0] == texts[1]
    assert texts[1].splitlines()[0] == ",".join(PM.MetricManager.CSV_HEADER)


def test_cardinality_guard_and_reset():
    m = PM.MetricManager()
    m.MAX_CHILDREN = 3
    for i in range(5):
        m.counter("c", labels={"tenant": str(i)}).inc()
    assert m.counter_value("c") == 5
    assert len(m.children("c")) == 3
    assert m.counter_value(PM.MetricManager.LABELS_DROPPED) == 2
    m.reset()
    assert m.snapshot() == {} and m.gauge_snapshot() == {}


def test_labeled_sum_exact_under_concurrent_updates():
    m = PM.MetricManager()
    n_threads, per = 8, 500

    def work(t):
        c = m.counter("serving.jobs.completed",
                      labels={"tenant": f"t{t % 3}"})
        for _ in range(per):
            c.inc()
    ts = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    total = m.counter_value("serving.jobs.completed")
    assert total == n_threads * per
    assert sum(c.count for _, c in m.children(
        "serving.jobs.completed")) == total


def test_the_port_registry_is_its_own_singleton():
    assert PM.MetricManager.instance() is PM.MetricManager.instance()
    assert PM.MetricManager.instance() is not JM.MetricManager.instance()


# --------------------------------------------------------------------------
# obs/tracing
# --------------------------------------------------------------------------

def _trace_workload(mod):
    clk = Clock()
    tr = mod["tracing"].Tracer(clock=clk)
    root = tr.start("job-1", "job", kind="bfs")
    h = mod["tracing"].TraceHandle(tr, "job-1", root)
    h.event("submit", parent=root)
    q = h.start("queue", parent=root)
    clk.advance(0.25)
    h.end(q)
    att = h.start("attempt", parent=root, attempt=1)
    run = h.start("run", parent=att, k=4)
    for lvl in range(3):
        h.event("round", parent=run, t0=clk(), t1=clk() + 0.01,
                level=lvl, frontier=lvl + 1)
        clk.advance(0.01)
    h.end(run, levels=3)
    h.end(att, state="done")
    h.event("done", parent=root)
    h.end(root, status="done")
    off = mod["tracing"].Tracer(enabled=False)
    return {"tree": tr.tree("job-1"),
            "summary": mod["tracing"].trace_summary(tr, "job-1"),
            "null": off.start("x", "y") is mod["tracing"].NULL_SPAN,
            "missing": tr.tree("nope")}


def test_span_trees_equal_the_jax_tracer():
    out = _both(_trace_workload)
    (root,) = out["tree"]["spans"]
    assert root["name"] == "job" and out["null"]
    assert [c["name"] for c in root["children"]] == \
        ["submit", "queue", "attempt", "done"]
    assert out["missing"] is None


def test_trace_lru_bound():
    tr = PTR.Tracer(clock=Clock(), max_traces=2)
    for i in range(4):
        tr.end(tr.start(f"t{i}", "job"))
    assert tr.tree("t0") is None and tr.tree("t3") is not None


# --------------------------------------------------------------------------
# obs/flightrec
# --------------------------------------------------------------------------

def _flight_workload(mod, tmp):
    m = mod["metrics"].MetricManager()
    rec = mod["flightrec"].FlightRecorder(str(tmp), capacity=4, metrics=m,
                                          clock=Clock())
    for i in range(6):
        rec.record("device", kernel=f"k{i}", ms=float(i))
    m.counter("serving.jobs.completed").inc(2)
    rec.metric_delta()
    path = rec.dump(reason="failed", job={"job": "job-9", "kind": "bfs"},
                    state={"scheduler": {"queue_depth": 0}},
                    config={"max_batch": 16})
    with open(path) as f:
        bundle = json.load(f)
    return {"kinds": [e["kind"] for e in rec.events()],
            "devices": [e.get("kernel") for e in rec.events("device")],
            "name": path.rsplit("/", 1)[1], "bundle": bundle,
            "written": m.counter_value("flightrec.dump.written"),
            "index": len(rec.index())}


def test_bundles_and_ring_equal_the_jax_recorder(tmp_path):
    j = _flight_workload(JAX, tmp_path / "j")
    p = _flight_workload(PORT, tmp_path / "p")
    assert p == j
    assert p["devices"] == ["k3", "k4", "k5"] and p["written"] == 1


def test_unwritable_dump_dir_counts_errors(tmp_path):
    m = PM.MetricManager()
    d = tmp_path / "dumps"
    rec = PFR.FlightRecorder(str(d), metrics=m)
    shutil.rmtree(d)                             # storage vanished
    with pytest.raises(OSError):
        rec.dump(reason="manual")
    assert m.counter_value("flightrec.dump.errors") == 1
    assert m.counter_value("flightrec.dump.written") == 0
    assert rec.index() == []


# --------------------------------------------------------------------------
# obs/slo
# --------------------------------------------------------------------------

def _slo_workload(mod):
    m = mod["metrics"].MetricManager()
    clk = Clock()
    slos = [mod["slo"].SLO("a-avail", tenant="a", success_rate=0.999,
                           windows=(300.0,)),
            mod["slo"].SLO("bfs-p95", algorithm="bfs", p95_ms=50.0,
                           windows=(60.0, 300.0))]
    eng = mod["slo"].SLOEngine(m, slos, clock=clk)
    eng.register_gauges()

    def step(tenant, kind, ok, bad, lat):
        m.counter("serving.jobs.completed",
                  labels={"kind": kind, "tenant": tenant}).inc(ok)
        m.counter("serving.jobs.failed",
                  labels={"kind": kind, "tenant": tenant}).inc(bad)
        h = m.histogram("serving.job.latency_ms",
                        labels={"kind": kind, "tenant": tenant})
        for x in lat:
            h.update(x)
    step("a", "bfs", 50, 0, [10.0] * 5)
    reports = [eng.evaluate()]
    clk.advance(300.0)
    step("a", "bfs", 97, 3, [20.0, 80.0, 90.0])
    step("b", "sssp", 10, 40, [500.0])
    reports.append(eng.evaluate())
    return {"reports": reports,
            "burn": eng.burn_rate("a-avail", 300.0),
            "gauges": m.gauge_snapshot()}


def test_slo_reports_equal_the_jax_engine():
    out = _both(_slo_workload)
    assert out["burn"] == pytest.approx(30.0)


def test_slo_declaration_validation():
    with pytest.raises(ValueError, match="exactly one"):
        PSLO.SLO("both", p95_ms=5.0, success_rate=0.99)
    with pytest.raises(ValueError, match="duplicate"):
        PSLO.SLOEngine(PM.MetricManager(), [PSLO.SLO("x", p95_ms=1.0),
                                            PSLO.SLO("x",
                                                     success_rate=0.5)])


# --------------------------------------------------------------------------
# olap/serving/tenants
# --------------------------------------------------------------------------

def _tenant_workload(mod):
    T = mod["tenants"]
    acc = T.TenantAccounting()
    q = T.TenantQuota(max_in_flight=2, max_hbm_bytes=100)
    whys = [acc.admit("a", q, True) for _ in range(3)]
    acc.unadmit("a")
    acc.queue_ms("a", 3.5)
    acc.device_seconds("a", 0.25)
    acc.hold_hbm("a", 150.0)
    whys.append(acc.admit("a", q, False))
    acc.drop_hbm("a", 150.0)
    acc.hbm_byte_seconds("a", 10.0)
    acc.finished("a", "completed", rounds_replayed=4)
    return {"whys": whys, "stats": acc.stats(), "wire": q.to_wire(),
            "default": T.effective_tenant(""),
            "named": T.effective_tenant(7)}


def test_tenant_accounting_equals_the_jax_package():
    out = _both(_tenant_workload)
    assert out["whys"][:2] == [None, None] and out["whys"][2] is not None
    assert out["default"] == "default" and out["named"] == "7"


# --------------------------------------------------------------------------
# olap/serving/autotune: the same decisions from the same readings
# --------------------------------------------------------------------------

def _sig(occ=None, batches=1, burn=0.0, burn_slo=None, protected=(),
         tenants=None, deltas=None, live=None, recovery=None,
         jobs_delta=0):
    return {"t": 0.0,
            "occupancy": {"recent_mean": occ, "batches": batches},
            "queue_depth": 0,
            "burn": ({burn_slo or "slo": {"300s": burn}} if burn else {}),
            "burn_max": burn, "burn_max_slo": burn_slo,
            "protected_tenants": sorted(protected),
            "tenants": tenants or {},
            "tenant_device_s_delta": deltas or {},
            "jobs_delta": jobs_delta, "recovery": recovery or {},
            **({"live": live} if live is not None else {})}


FEEDS = [
    _sig(occ=8.0), _sig(occ=16.0), _sig(occ=16.0), _sig(occ=2.0),
    _sig(occ=None, batches=0, burn=3.0, burn_slo="q", protected=("q",),
         tenants={"flood": {"in_flight": 3, "device_seconds": 1.0}},
         deltas={"flood": 0.4}),
    _sig(occ=None, batches=0, burn=0.0, protected=("q",)),
    _sig(occ=None, batches=0, jobs_delta=10,
         live={"overlay_rows": 1000, "tombs": 50, "fill": 0.2,
               "tomb_fraction": 0.01, "base_edges": 10_000,
               "merge_us_per_row": 0.05, "fallbacks": 0}),
    _sig(occ=None, batches=0,
         recovery={"retries_delta": 2, "replayed_delta": 36,
                   "checkpoint_ms_mean": 8.0, "round_ms_mean": 4.0}),
]


@pytest.mark.parametrize("mode", ["shadow", "enforce"])
def test_controller_journals_equal_the_jax_controller(mode):
    def run(mod):
        clk = Clock()
        it = iter(FEEDS)
        m = mod["metrics"].MetricManager()
        ctl = mod["autotune"].Controller(
            mode=mode, clock=clk, signals=lambda: dict(next(it)),
            metrics=m, k_init=8)
        for _ in FEEDS:
            ctl.tick(force=True)
            clk.advance(31.0)
        return {"journal": ctl.journal(), "state": ctl.state(),
                "k": ctl.target_k, "every": ctl.checkpoint_every,
                "metrics": m.snapshot(), "labeled": m.labeled()}
    out = _both(run)
    rules = {e["rule"] for e in out["journal"]}
    assert {"batch_k.grow", "batch_k.shrink", "tenant.shed",
            "live.compact", "recovery.cadence"} <= rules
    for e in out["journal"]:
        assert PAT.replay(e)["new"] == e["new"]
    assert all(e["applied"] == (mode == "enforce")
               for e in out["journal"]
               if e["rule"] != "live.compact")


def test_mode_resolution():
    for v, want in ((None, "shadow"), ("", "shadow"), ("OFF", "off"),
                    ("enforce", "enforce"), ("1", "enforce")):
        assert PAT.resolve_mode(v) == JAT.resolve_mode(v) == want
    with pytest.raises(ValueError):
        PAT.resolve_mode("sideways")


# --------------------------------------------------------------------------
# obs/devprof (rewritten for CUDA; the CPU path here)
# --------------------------------------------------------------------------

def _snap(seed=42, n=192, m=900):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, m)
    d = rng.integers(0, n, m)
    return SN.from_arrays(n, np.concatenate([s, d]), np.concatenate([d, s]))


@pytest.fixture
def clean_profilers():
    """Park profilers other tests may have left installed, so on/off
    compares this test's profiler against none."""
    saved = list(devprof._PROFILERS)
    devprof._PROFILERS.clear()
    yield
    devprof._PROFILERS[:] = saved


def _workload(snap):
    from titan_tpu_torch.models import pagerank as MP
    inv = np.where(snap.out_degree > 0,
                   1.0 / np.maximum(snap.out_degree, 1), 0.0)
    pr = E.run_single(MP.PageRank(0.85, 6, 0.0), snap,
                      {"n": snap.n, "inv_outdeg": inv.astype(np.float32)},
                      device="cpu")
    dist, levels, _ = P.frontier_bfs_batched(snap, [0, 3, 7, 11],
                                             device="cpu")
    return pr["rank"], dist, levels


def test_bit_equal_with_profiling_on_and_off(clean_profilers, monkeypatch):
    # one chunk round forces the stragglers through batched_exhaust
    monkeypatch.setattr(P, "BU_CHUNK_ROUNDS", 1)
    snap = _snap()
    off = _workload(snap)
    m = PM.MetricManager()
    with devprof.DeviceCostProfiler(metrics=m) as prof:
        on = _workload(snap)
    for a, b in zip(off, on):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    ks = prof.kernel_stats()
    for key in ("frontier_round", "batched_exhaust", "seg_scan",
                "engine.superstep", "engine.prepare", "engine.gather",
                "engine.combine", "bfs_batched.plan", "bfs_batched.sweep",
                "bfs_batched.readback"):
        assert ks[key]["calls"] > 0 and ks[key]["exec_s"] > 0, key
        assert m.counter_value("device.exec.calls",
                               {"kernel": key}) == ks[key]["calls"]
    assert ks["engine.superstep"]["calls"] == 6
    assert ks["seg_scan"]["calls"] == 6
    st = prof.stats()
    assert st["calls"] == sum(k["calls"] for k in ks.values())
    # seams run inside others: seg_scan inside engine.combine, the
    # gather and the combine inside engine.superstep, the two BFS
    # kernels inside bfs_batched.sweep. The totals count each once
    nested = ("seg_scan", "engine.gather", "engine.combine",
              "frontier_round", "batched_exhaust")
    top = sum(k["exec_s"] for name, k in ks.items() if name not in nested)
    assert st["exec_s"] == pytest.approx(top, rel=1e-3, abs=1e-5)
    assert st["compiles"] == 0 and st["cache_hits"] == st["calls"]


def test_transfer_sites_counted_once_per_upload(clean_profilers):
    snap = _snap(3)
    m = PM.MetricManager()
    with devprof.DeviceCostProfiler(metrics=m) as prof:
        w = prof.window()
        _workload(snap)
        _workload(snap)
        cost = w.close()

    def site(name, s):
        return m.counter_value(name, {"site": s})
    csr = P.build_chunked_csr(snap, "cpu")
    csr_bytes = sum(csr[k].numel() * 4
                    for k in ("dstT", "colstart", "degc", "deg"))
    assert site("device.xfer.h2d_bytes", "bfs.chunked_csr") == csr_bytes
    assert site("device.xfer.h2d_bytes", "engine.graph") > 0
    assert site("device.xfer.d2h_bytes", "bfs.dist") == 2 * 4 * snap.n * 4
    assert site("device.xfer.d2h_bytes", "engine.outputs") == \
        2 * snap.n * 4
    assert cost["h2d_bytes"] == m.counter_value("device.xfer.h2d_bytes")
    assert cost["calls"] > 0 and cost["wall_s"] >= 0


def test_no_profiler_means_the_plain_call(clean_profilers):
    calls = []
    out = devprof.profiled("k", lambda x: calls.append(x) or x * 2, 21)
    assert out == 42 and calls == [21]
    devprof.count_h2d("s", 10)            # nothing installed: no-op
    assert devprof.current() is None


def test_nested_seams_and_fan_out(clean_profilers):
    m1, m2 = PM.MetricManager(), PM.MetricManager()
    p1 = devprof.DeviceCostProfiler(metrics=m1).install()
    p2 = devprof.DeviceCostProfiler(metrics=m2).install()
    try:
        t = torch.ones(4)

        def inner(x):
            return x + 1

        def outer(x):
            return devprof.profiled("inner", inner, x) * 2
        assert torch.equal(devprof.profiled("outer", outer, t),
                           torch.full((4,), 4.0))
        assert devprof.current() is p2
    finally:
        p2.uninstall()
        p1.uninstall()
    for p, m in ((p1, m1), (p2, m2)):
        ks = p.kernel_stats()
        assert ks["outer"]["calls"] == ks["inner"]["calls"] == 1
        assert p.stats()["exec_s"] == pytest.approx(ks["outer"]["exec_s"],
                                                    abs=1e-6)
        assert m.histogram_stats("device.exec.ms")["count"] == 2
    assert not p1.installed and devprof._PROFILERS == []


@pytest.mark.skipif(shutil.which("cc") is None and shutil.which("gcc") is
                    None, reason="needs a C compiler")
def test_builds_count_as_compiles(clean_profilers, tmp_path):
    cc = shutil.which("cc") or shutil.which("gcc")
    src = tmp_path / "lib.c"
    src.write_text("int tt_one(void) { return 1; }\n")
    cmd = [cc, "-shared", "-fPIC"]
    m = PM.MetricManager()
    with devprof.DeviceCostProfiler(metrics=m) as prof:
        # inside a seam: the call is marked compiled (no cache hit)
        devprof.profiled("lib.load", build.build_shared, str(src), cmd,
                         str(tmp_path / "b"), "lib")
        # built already: counts nothing
        build.build_shared(str(src), cmd, str(tmp_path / "b"), "lib")
        # outside any seam: under the library's name
        src.write_text("int tt_one(void) { return 2; }\n")
        build.build_shared(str(src), cmd, str(tmp_path / "b"), "lib")
    assert prof.compiles() == 2
    assert prof.compiles("lib.load") == 1 and prof.compiles("lib") == 1
    assert m.counter_value("device.compile.count") == 2
    assert m.counter_value("device.compile.cache_hits") == 0
    assert [e["kernel"] for e in prof.compile_log()] == ["lib.load", "lib"]


def test_overlay_uploads_mirror_onto_the_h2d_family(clean_profilers):
    from titan_tpu_torch.olap.live.overlay import DeltaOverlay

    snap = _snap(5)
    reg, m = PM.MetricManager(), PM.MetricManager()
    rng = np.random.default_rng(0)
    with devprof.DeviceCostProfiler(metrics=m):
        ov = DeltaOverlay(snap, min_cap=64, metrics=reg, device="cpu")
        ov.append_edges(rng.integers(0, snap.n, 40).astype(np.int32),
                        rng.integers(0, snap.n, 40).astype(np.int32),
                        np.zeros(40, np.int32))
        ov.remove_edge(int(snap.src[0]), int(snap.dst[0]), None)
        ov.view()
    up = reg.counter_value("serving.live.upload_bytes")
    assert up > 0
    assert m.counter_value("device.xfer.h2d_bytes",
                           {"site": "overlay.delta"}) == up


def test_personalized_batch_readback_counts_on_frontier_result(
        clean_profilers):
    from titan_tpu_torch.models import pagerank as MP

    snap = _snap(9)
    m = PM.MetricManager()
    with devprof.DeviceCostProfiler(metrics=m):
        ranks, _ = MP.pagerank_personalized_batched(snap, [0, 4, 8],
                                                    iterations=3,
                                                    device="cpu")
        MP.pagerank_personalized_batched(snap, [1], iterations=2,
                                         return_device=True, device="cpu")
    assert m.counter_value("device.xfer.d2h_bytes",
                           {"site": "frontier.result"}) == ranks.nbytes
