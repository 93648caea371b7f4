"""The port's serving layer (``titan_tpu_torch/olap/serving``) against the
JAX package's on the same specs: BFS fusion, admission, cancellation,
deadlines, timeouts and malformed jobs.

Both schedulers run paused (``autostart=False``) until every job is
queued, so the batch compositions are fixed; each has its own
``MetricManager``; the port runs with ``device="cpu"``. The budget is
passed to both (the JAX default is a share of a TPU's memory, the port's
a share of the card's). Every wait has a timeout and every scheduler is
closed in a ``finally``."""

import time

import numpy as np
import pytest

import titan_tpu.olap.api as JA
import titan_tpu.olap.serving.scheduler as JSCH
import titan_tpu.utils.metrics as JM
import titan_tpu_torch.olap.api as PA
import titan_tpu_torch.olap.serving.scheduler as PSCH
import titan_tpu_torch.utils.metrics as PM
from titan_tpu.models import bfs_hybrid as H
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu_torch.models import bfs_hybrid as P
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.serving.hbm import snapshot_csr_bytes

N, M, SEED = 192, 900, 42
BUDGET = 1e12
WAIT = 120


def _pair(seed=SEED, n=N, m=M):
    """The same symmetric graph as a JAX and a port snapshot."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, m).astype(np.int32)
    d = rng.integers(0, n, m).astype(np.int32)
    src, dst = np.concatenate([s, d]), np.concatenate([d, s])
    return JS.from_arrays(n, src, dst), PS.from_arrays(n, src, dst)


@pytest.fixture(scope="module")
def snaps():
    return _pair()


def _sched(which, snap, **kw):
    kw.setdefault("hbm_budget_bytes", BUDGET)
    kw.setdefault("autostart", False)
    if which == "jax":
        return JSCH.JobScheduler(snapshot=snap, metrics=JM.MetricManager(),
                                 **kw)
    return PSCH.JobScheduler(snapshot=snap, metrics=PM.MetricManager(),
                             device="cpu", **kw)


def _settle(sched, n_jobs, timeout=30.0):
    """Job.wait() fires inside the batch; the worker finalizes the
    terminal counters just after — wait for all of them."""
    names = [f"serving.jobs.{s}" for s in
             ("completed", "failed", "timeout", "cancelled", "expired")]
    deadline = time.time() + timeout
    while time.time() < deadline and sum(
            sched._metrics.counter_value(x) for x in names) < n_jobs:
        time.sleep(0.01)


def _serve(which, snap, specs, **kw):
    """Submit ``specs`` (built by ``specs(api)``) to a paused scheduler,
    start it, wait for every job; returns ``(jobs, metrics)``."""
    api = JA if which == "jax" else PA
    sched = _sched(which, snap, **kw)
    try:
        jobs = [sched.submit(s) for s in specs(api)]
        sched.start()
        for j in jobs:
            assert j.wait(WAIT), j
        _settle(sched, len(jobs))
        return jobs, sched._metrics
    finally:
        sched.close()


def _states(jobs):
    return [(j.state.value, j.batch_k, j.attempt) for j in jobs]


def _counters(m, names):
    return {n: m.counter_value(n) for n in names}


COUNTERS = [f"serving.jobs.{s}" for s in
            ("submitted", "completed", "failed", "cancelled", "expired",
             "timeout", "rejected")] + ["serving.queue.depth"]


@pytest.mark.parametrize("K", [1, 8])
def test_fused_bfs_batch_equals_jax(snaps, K):
    js, ps = snaps
    nz = np.flatnonzero(ps.out_degree > 0)
    srcs = [int(s) for s in nz[:K]]

    def specs(api):
        return [api.JobSpec(kind="bfs", params={"source_dense": s})
                for s in srcs]
    jj, jm = _serve("jax", js, specs)
    pj, pm = _serve("port", ps, specs)
    assert _states(pj) == _states(jj) == [("done", K, 1)] * K
    for a, b, s in zip(jj, pj, srcs):
        assert np.array_equal(a.result["dist"], b.result["dist"])
        assert (a.result["levels"], a.result["reached"], a.result["n"]) \
            == (b.result["levels"], b.result["reached"], b.result["n"])
        ref, _ = P.frontier_bfs_hybrid(ps, s, device="cpu")
        assert np.array_equal(b.result["dist"], ref)
    for m in (jm, pm):
        occ = m.histogram("serving.batch.occupancy")
        assert (occ.count, occ.max) == (1, float(K))
        assert m.histogram("serving.job.latency_ms").count == K
    assert _counters(pm, COUNTERS) == _counters(jm, COUNTERS)


def test_targets_and_max_levels_equal_jax(snaps):
    js, ps = snaps
    nz = np.flatnonzero(ps.out_degree > 0)

    def specs(api):
        return [api.JobSpec(kind="bfs",
                            params={"source_dense": int(nz[0]),
                                    "targets": [int(nz[1]), "x", 10**9]}),
                api.JobSpec(kind="bfs",
                            params={"source_dense": int(nz[2]),
                                    "max_levels": 2}),
                api.JobSpec(kind="bfs",
                            params={"source_dense": int(nz[3]),
                                    "max_levels": 2})]
    jj, _ = _serve("jax", js, specs)
    pj, _ = _serve("port", ps, specs)
    assert _states(pj) == _states(jj)
    assert pj[0].result["targets"] == jj[0].result["targets"]
    assert pj[0].result["targets"]["x"] is None
    # max_levels is part of the batch key: the two capped jobs fused
    assert pj[1].batch_k == pj[2].batch_k == 2
    for a, b in zip(jj, pj):
        assert np.array_equal(a.result["dist"], b.result["dist"])
        assert a.result["levels"] == b.result["levels"]


def test_cancel_deadline_timeout_equal_jax(snaps):
    js, ps = snaps
    src = int(np.flatnonzero(ps.out_degree > 0)[0])
    out = {}
    for which, snap, api in (("jax", js, JA), ("port", ps, PA)):
        sched = _sched(which, snap)
        try:
            c = sched.submit(api.JobSpec(kind="bfs",
                                         params={"source_dense": src}))
            assert sched.cancel(c.id) and c.state.value == "cancelled"
            e = sched.submit(api.JobSpec(kind="bfs",
                                         params={"source_dense": src},
                                         deadline=time.time() - 1))
            t = sched.submit(api.JobSpec(kind="bfs",
                                         params={"source_dense": src},
                                         timeout_s=0.0))
            late = sched.submit(api.JobSpec(kind="bfs",
                                            params={"source_dense": src},
                                            deadline=time.time() + 0.05))
            time.sleep(0.1)              # its start-deadline passes, paused
            ok = sched.submit(api.JobSpec(kind="bfs",
                                          params={"source_dense": src}))
            sched.start()
            for j in (c, e, t, late, ok):
                assert j.wait(WAIT), j
            _settle(sched, 5)
            out[which] = ([j.state.value for j in (c, e, t, late, ok)],
                          _counters(sched._metrics, COUNTERS))
        finally:
            sched.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["cancelled", "expired", "timeout", "expired",
                              "done"]


def test_admission_refuses_an_image_over_budget(snaps):
    js, ps = snaps
    errors = {}
    for which, snap in (("jax", js), ("port", ps)):
        def specs(api):
            return [api.JobSpec(kind="bfs", params={"source_dense": 0})]
        jobs, m = _serve(which, snap, specs, hbm_budget_bytes=64)
        assert jobs[0].state.value == "failed"
        errors[which] = jobs[0].error
    assert "admission" in errors["port"]
    assert errors["port"].split(":")[0] == errors["jax"].split(":")[0]


def test_malformed_jobs_fail_alone_as_in_jax(snaps):
    js, ps = snaps
    src = int(np.flatnonzero(ps.out_degree > 0)[0])

    def specs(api):
        return [api.JobSpec(kind="bfs", params={"source": None}),
                api.JobSpec(kind="bfs", params={"source_dense": src,
                                                "max_levels": "soon"}),
                api.JobSpec(kind="bfs", params={}),
                api.JobSpec(kind="sssp", params={"source": "x"}),
                api.JobSpec(kind="bfs", params={"source_dense": src})]
    jj, jm = _serve("jax", js, specs)
    pj, pm = _serve("port", ps, specs)
    assert [j.state.value for j in pj] == [j.state.value for j in jj] == \
        ["failed"] * 4 + ["done"]
    for a, b in zip(jj, pj):
        assert (a.error is None) == (b.error is None)
    assert "source" in pj[0].error and "source" in pj[2].error
    assert _counters(pm, COUNTERS) == _counters(jm, COUNTERS)


def test_unknown_kind_and_faults_rejected_at_submit(snaps):
    _, ps = snaps
    sched = _sched("port", ps)
    try:
        with pytest.raises(ValueError, match="unknown job kind"):
            sched.submit(PA.JobSpec(kind="nope"))
        with pytest.raises(ValueError, match="FaultPlan"):
            sched.submit(PA.JobSpec(kind="bfs", params={"faults": 3}))
        assert sched._metrics.counter_value("serving.jobs.rejected") == 2
        assert sched._metrics.counter_value("serving.jobs.submitted") == 0
    finally:
        sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(PA.JobSpec(kind="bfs", params={"source_dense": 0}))


def test_ledger_charges_the_chunked_csr_and_eviction_drops_it(snaps):
    _, ps = snaps
    snap = PS.from_arrays(ps.n, ps.src, ps.dst)
    sched = _sched("port", snap)
    try:
        j = sched.submit(PA.JobSpec(kind="bfs", params={"source_dense": 1}))
        sched.start()
        assert j.wait(WAIT) and j.state.value == "done"
        _settle(sched, 1)
        assert sched.ledger.resident_bytes() == snapshot_csr_bytes(snap)
        assert sched.ledger.pinned_bytes() == 0
        (g,) = snap._hybrid_csr_by_device.values()
        assert sum(g[k].numel() * 4 for k in
                   ("dstT", "colstart", "degc", "deg")) == \
            sched.ledger.resident_bytes()
        # a second image over the budget evicts the idle first one
        sched.ledger.budget_bytes = snapshot_csr_bytes(snap) + 10
        sched.ledger.reserve("other", 20)
        assert not hasattr(snap, "_hybrid_csr_by_device")
        assert not hasattr(snap, "_device_graphs")
        assert sched.ledger.resident_bytes() == 20
    finally:
        sched.close()
    # the engine and the BFS rebuild what eviction dropped
    d, _, _ = P.frontier_bfs_batched(snap, [1], device="cpu")
    assert np.array_equal(d[0], j.result["dist"])


def test_stats_and_gauges(snaps):
    _, ps = snaps
    sched = _sched("port", ps)
    try:
        jobs = [sched.submit(PA.JobSpec(kind="bfs",
                                        params={"source_dense": s}))
                for s in range(3)]
        st = sched.stats()
        assert st["queue_depth"] == 3 and st["pool_snapshots"] == 1
        assert sched._metrics.counter_value("serving.queue.depth") == 3
        sched.start()
        for j in jobs:
            assert j.wait(WAIT)
        _settle(sched, 3)
        gs = sched._metrics.gauge_snapshot()
        assert gs["serving.hbm.resident_bytes"]["value"] == \
            snapshot_csr_bytes(ps)
        assert gs["serving.pool.snapshots"]["value"] == 1.0
        assert sched.stats()["by_state"] == {"done": 3}
    finally:
        sched.close()
    # closed: the gauges read 0 and no longer pin the scheduler
    assert sched._metrics.gauge_snapshot()[
        "serving.hbm.resident_bytes"]["value"] == 0.0


def test_jax_and_port_build_the_same_layout(snaps):
    js, ps = snaps
    jg, pg = H.build_chunked_csr(js), P.build_chunked_csr(ps, "cpu")
    assert np.array_equal(np.asarray(jg["dstT"]), pg["dstT"].numpy())
