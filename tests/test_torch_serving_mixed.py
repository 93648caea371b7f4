"""A mixed stream through the port's scheduler and the JAX package's, on
the same specs under two tenants: SSSP and WCC cohorts, PageRank,
a DenseProgram PageRank and host callables. Results agree (SSSP, WCC
exact, ``pagerank`` bit-equal, ``dense`` within rtol 1e-5), and so does
the bookkeeping: batch compositions, occupancy, per-tenant attribution
keys, span names and nesting (timestamps aside) and metric family
names."""

import time

import numpy as np
import pytest

import titan_tpu.models.pagerank as JPR
import titan_tpu.olap.api as JA
import titan_tpu.olap.serving.scheduler as JSCH
import titan_tpu.utils.metrics as JM
import titan_tpu_torch.models.pagerank as PPR
import titan_tpu_torch.olap.api as PA
import titan_tpu_torch.olap.serving.scheduler as PSCH
import titan_tpu_torch.utils.metrics as PM
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu_torch.models import frontier as FR
from titan_tpu_torch.obs import SLO
from titan_tpu_torch.olap import engine as E
from titan_tpu_torch.olap import snapshot as PS

N, M, SEED = 192, 900, 42
WAIT = 120
DENSE_RTOL = 1e-5


@pytest.fixture(scope="module")
def snaps():
    rng = np.random.default_rng(SEED)
    s = rng.integers(0, N, M).astype(np.int32)
    d = rng.integers(0, N, M).astype(np.int32)
    src, dst = np.concatenate([s, d]), np.concatenate([d, s])
    return JS.from_arrays(N, src, dst), PS.from_arrays(N, src, dst)


def _specs(api, prog_mod, snap):
    inv = np.where(snap.out_degree > 0,
                   1.0 / np.maximum(snap.out_degree, 1), 0.0) \
        .astype(np.float32)
    nz = np.flatnonzero(snap.out_degree > 0)
    out = []
    for i in range(4):
        out.append(api.JobSpec(kind="sssp", tenant="alpha",
                               params={"source_dense": int(nz[i])}))
    for i in range(3):
        out.append(api.JobSpec(kind="wcc", tenant="beta"))
    out.append(api.JobSpec(kind="pagerank", tenant="alpha",
                           params={"iterations": 7}))
    out.append(api.JobSpec(kind="dense", tenant="beta",
                           params={"program": prog_mod.PageRank(0.85, 9,
                                                                 0.0),
                                   "n": snap.n, "inv_outdeg": inv}))
    out.append(api.JobSpec(kind="callable", params={"fn": lambda: 42}))
    out.append(api.JobSpec(kind="sssp", tenant="beta",
                           params={"source_dense": int(nz[5]),
                                   "delta": 0.25}))
    return out


def _serve(which, snap):
    if which == "jax":
        sched = JSCH.JobScheduler(snapshot=snap, metrics=JM.MetricManager(),
                                  autostart=False, hbm_budget_bytes=1e12)
        specs = _specs(JA, JPR, snap)
    else:
        sched = PSCH.JobScheduler(snapshot=snap, metrics=PM.MetricManager(),
                                  autostart=False, hbm_budget_bytes=1e12,
                                  device="cpu")
        specs = _specs(PA, PPR, snap)
    try:
        jobs = [sched.submit(s) for s in specs]
        sched.start()
        for j in jobs:
            assert j.wait(WAIT), j
        deadline = time.time() + 30
        while time.time() < deadline and sched._metrics.counter_value(
                "serving.jobs.completed") < len(jobs):
            time.sleep(0.01)
        return sched, jobs
    finally:
        sched.close()


@pytest.fixture(scope="module")
def served(snaps):
    js, ps = snaps
    return _serve("jax", js), _serve("port", ps)


def test_results_equal_jax(served, snaps):
    (_, jj), (_, pj) = served
    _, ps = snaps
    assert [j.state.value for j in pj] == [j.state.value for j in jj] == \
        ["done"] * len(pj)
    for a, b in zip(jj, pj):
        kind = b.spec.kind
        if kind == "sssp":
            assert np.array_equal(a.result["dist"].view(np.int32),
                                  b.result["dist"].view(np.int32))
            assert a.result["rounds"] == b.result["rounds"]
            assert a.result["reached"] == b.result["reached"]
        elif kind == "wcc":
            assert np.array_equal(a.result["labels"], b.result["labels"])
            assert (a.result["rounds"], a.result["components"]) == \
                (b.result["rounds"], b.result["components"])
        elif kind == "pagerank":
            assert np.array_equal(a.result["rank"].view(np.int32),
                                  b.result["rank"].view(np.int32))
            assert a.result["iterations"] == b.result["iterations"] == 7
        elif kind == "dense":
            assert a.result["iterations"] == b.result["iterations"] == 9
            np.testing.assert_allclose(b.result["rank"], a.result["rank"],
                                       rtol=DENSE_RTOL)
        else:
            assert a.result == b.result == {"value": 42}
    # every result equals the port's direct call
    rank, _ = FR.pagerank_dense(ps, iterations=7, device="cpu")
    assert np.array_equal(pj[7].result["rank"], rank)
    inv = np.where(ps.out_degree > 0, 1.0 / np.maximum(ps.out_degree, 1),
                   0.0).astype(np.float32)
    direct = E.run_single(PPR.PageRank(0.85, 9, 0.0), ps,
                          {"n": ps.n, "inv_outdeg": inv}, device="cpu")
    assert np.array_equal(pj[8].result["rank"], direct["rank"])
    d, r = FR.frontier_sssp(ps, int(pj[10].spec.params["source_dense"]),
                            delta=0.25, device="cpu")
    assert np.array_equal(pj[10].result["dist"], d)
    assert pj[10].result["rounds"] == r


def test_batch_compositions_equal_jax(served):
    (js, jj), (ps, pj) = served
    assert [j.batch_k for j in pj] == [j.batch_k for j in jj] == \
        [4] * 4 + [3] * 3 + [1] * 4
    jo = js._metrics.histogram("serving.batch.occupancy")
    po = ps._metrics.histogram("serving.batch.occupancy")
    assert sorted(po.values()) == sorted(jo.values())


def test_tenant_attribution_equal_jax(served):
    (js, jj), (ps, pj) = served
    jt, pt = js.tenant_stats(), ps.tenant_stats()
    assert set(pt["tenants"]) == set(jt["tenants"]) == \
        {"alpha", "beta", "default"}
    for t in pt["tenants"]:
        a, b = jt["tenants"][t], pt["tenants"][t]
        assert set(a) == set(b)
        for k in ("in_flight", "admitted", "completed", "failed",
                  "rounds_replayed"):
            if k in a:
                assert a[k] == b[k], (t, k)
    # the labeled per-tenant device-seconds sum to the batch walls
    dev = sum(r["device_seconds"] for r in pt["tenants"].values())
    assert dev == pytest.approx(sum(j.device_seconds for j in pj))
    for m in (js._metrics, ps._metrics):
        kids = m.children("serving.jobs.completed")
        assert sum(c.count for _, c in kids) == \
            m.counter_value("serving.jobs.completed") == len(pj)
        assert {lab["tenant"] for lab, _ in kids} == \
            {"alpha", "beta", "default"}


def _shape(node):
    """A span tree without timestamps or attributes: names and nesting,
    the devprof ``device_cost`` event left out (the JAX package profiles
    every jitted call, the port its kernel seams, so a batch that
    launches none of the port's kernels records none)."""
    return (node["name"],
            tuple(_shape(c) for c in node["children"]
                  if c["name"] != "device_cost"))


def test_span_names_and_nesting_equal_jax(served):
    (js, jj), (ps, pj) = served
    for a, b in zip(jj, pj):
        ta, tb = js.tracer.tree(a.id), ps.tracer.tree(b.id)
        assert [_shape(s) for s in tb["spans"]] == \
            [_shape(s) for s in ta["spans"]], b.spec.kind
    # the port's dense job ran through seg_scan: its device cost is
    # stitched into its trace
    def walk(node):
        yield node
        for c in node["children"]:
            yield from walk(c)
    (root,) = ps.tracer.tree(pj[8].id)["spans"]
    costs = [c for c in walk(root) if c["name"] == "device_cost"]
    # every device seam call counts: the job's 9 supersteps each call
    # engine.superstep, engine.gather, engine.combine and seg_scan, and
    # engine.prepare runs once, so 9 * 4 + 1 (host stages count none)
    assert len(costs) == 1 and costs[0]["attrs"]["kernel_calls"] == 37
    assert ps.trace_summary(pj[0].id)["rounds"] > 0


def test_metric_family_names_equal_jax(served):
    """The same families after the same workload, two groups aside: the
    devprof compile families (XLA compiles in JAX, nvcc builds in the
    port, each depending on what the process built before) and the
    controller's, which appear when its wall-clock tick fires."""
    (js, _), (ps, _) = served

    def families(m):
        return {n for n in set(m.snapshot()) | set(m.gauge_snapshot())
                if not n.startswith(("device.compile.", "controller."))}
    assert families(ps._metrics) == families(js._metrics)
    assert {"device.exec.calls", "device.exec.ms", "device.xfer.h2d_bytes",
            "device.xfer.d2h_bytes"} <= families(ps._metrics)


def test_slo_engine_reads_the_served_stream(snaps):
    _, ps = snaps
    sched = PSCH.JobScheduler(
        snapshot=ps, metrics=PM.MetricManager(), autostart=False,
        hbm_budget_bytes=1e12, device="cpu",
        slos=[SLO("alpha-ok", tenant="alpha", success_rate=0.99)])
    try:
        jobs = [sched.submit(PA.JobSpec(kind="callable", tenant="alpha",
                                        params={"fn": lambda: 1}))
                for _ in range(3)]
        sched.start()
        for j in jobs:
            assert j.wait(WAIT)
        deadline = time.time() + 30
        while time.time() < deadline and sched._metrics.counter_value(
                "serving.jobs.completed") < 3:
            time.sleep(0.01)
        rep = sched.slo_report()
        (s,) = rep["slos"]
        assert s["slo"] == "alpha-ok" and s["tenant"] == "alpha"
        assert s["sli"]["events"] == 3 and s["sli"]["bad"] == 0
    finally:
        sched.close()
