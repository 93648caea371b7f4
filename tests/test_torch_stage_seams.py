"""The served path's stage seams (``obs/devprof``): the worker loop's
host stages (``serving.wait``, ``serving.dispatch``, ``serving.result``)
and the device seams of the batched BFS (``bfs_batched.plan``,
``.sweep``, ``.readback``) and of the engine (``engine.prepare``,
``engine.gather``, ``engine.combine``), served through ``JobScheduler``
on a small R-MAT graph: their call counts, host stages kept out of the
device totals, answers bit-equal with profiling and tracing on and off,
nothing made while no profiler is installed, and the ranges they open
in a ``torch.profiler`` trace."""

import json
import time
import types

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

import titan_tpu_torch.olap.api as PA
import titan_tpu_torch.olap.serving.scheduler as PSCH
import titan_tpu_torch.utils.metrics as PM
from titan_tpu_torch.models import pagerank as MP
from titan_tpu_torch.obs import devprof
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.rmat import rmat_edges

WAIT = 120
K = 4
SUPERSTEPS = 20
HOST = ("serving.wait", "serving.dispatch", "serving.result")
DEVICE = ("bfs_batched.plan", "bfs_batched.sweep", "bfs_batched.readback",
          "engine.prepare", "engine.gather", "engine.combine")
#: device seams called inside another device seam
NESTED = ("seg_scan", "engine.gather", "engine.combine", "frontier_round",
          "batched_exhaust")


@pytest.fixture(scope="module")
def snap():
    s, d = rmat_edges(9, 8, seed=5)
    return PS.from_arrays(1 << 9, np.concatenate([s, d]),
                          np.concatenate([d, s]))


@pytest.fixture
def clean_profilers():
    """Park profilers other tests may have left installed, so each
    scheduler's profiler is the only one."""
    saved = list(devprof._PROFILERS)
    devprof._PROFILERS.clear()
    yield
    devprof._PROFILERS[:] = saved


def _bfs_specs(snap):
    nz = np.flatnonzero(snap.out_degree > 0)
    return [PA.JobSpec(kind="bfs", params={"source_dense": int(nz[i * 7])})
            for i in range(K)]


def _dense_spec(snap):
    inv = np.where(snap.out_degree > 0,
                   1.0 / np.maximum(snap.out_degree, 1), 0.0)
    return PA.JobSpec(kind="dense", params={
        "program": MP.PageRank(0.85, SUPERSTEPS, 0.0), "n": snap.n,
        "inv_outdeg": inv.astype(np.float32)})


def _serve(snap, specs, on=True):
    """Serve ``specs`` (submitted while the worker is stopped, so a BFS
    group fuses whole) and return the scheduler, its jobs and its
    profiler's ``kernel_stats()`` once every job is back and the worker
    has waited on the empty queue."""
    sched = PSCH.JobScheduler(snapshot=snap, metrics=PM.MetricManager(),
                              autostart=False, hbm_budget_bytes=1e12,
                              device="cpu", profiling=on, tracing=on)
    try:
        jobs = [sched.submit(s) for s in specs]
        sched.start()
        for j in jobs:
            assert j.wait(WAIT), j
        ks = {}
        deadline = time.time() + 30
        while on and time.time() < deadline:
            ks = sched.profiler.kernel_stats()
            if ks.get("serving.wait", {}).get("calls", 0) > 0:
                break
            time.sleep(0.01)
        return sched, jobs, ks
    finally:
        sched.close()


def test_call_counts_of_a_served_batch_and_job(snap, clean_profilers):
    sched, jobs, ks = _serve(snap, _bfs_specs(snap))
    assert [j.state.value for j in jobs] == ["done"] * K
    assert [j.batch_k for j in jobs] == [K] * K
    # one batch: one readback and one result assembly
    assert ks["bfs_batched.readback"]["calls"] == 1
    assert ks["serving.result"]["calls"] == 1
    # a plan a level (the one that finds every frontier empty included)
    levels = max(j.result["levels"] for j in jobs)
    assert ks["bfs_batched.plan"]["calls"] >= levels
    assert ks["bfs_batched.sweep"]["calls"] >= levels - 1 >= 1
    assert ks["serving.dispatch"]["calls"] >= 2
    assert ks["serving.wait"]["calls"] >= 1
    for key in HOST + DEVICE[:3]:
        assert ks[key]["exec_s"] > 0, key

    sched, (job,), ks = _serve(snap, [_dense_spec(snap)])
    assert job.state.value == "done"
    assert job.result["iterations"] == SUPERSTEPS
    for key in ("engine.superstep", "engine.gather", "engine.combine",
                "seg_scan"):
        assert ks[key]["calls"] == SUPERSTEPS, key
    assert ks["engine.prepare"]["calls"] == 1
    assert ks["serving.result"]["calls"] == 1
    assert "bfs_batched.readback" not in ks


def test_host_stages_stay_out_of_the_device_totals(snap, clean_profilers):
    sched, (job,), ks = _serve(snap, [_dense_spec(snap)])
    m = sched._metrics
    st = sched.profiler.stats()
    device = {k: v for k, v in ks.items() if k not in HOST}
    assert set(HOST) <= set(ks)
    assert st["calls"] == sum(v["calls"] for v in device.values())
    top = sum(v["exec_s"] for k, v in device.items() if k not in NESTED)
    assert st["exec_s"] == pytest.approx(top, rel=1e-3, abs=1e-5)
    assert st["cache_hits"] == st["calls"]
    for family in ("device.exec.calls", "device.compile.cache_hits"):
        kids = {lab["kernel"] for lab, _ in m.children(family)}
        assert kids == set(device), family
    assert {lab["kernel"] for lab, _ in m.children("device.exec.ms")} \
        == set(device)
    # the job's device cost counts its device seams only: 20 supersteps
    # of engine.superstep, engine.gather, engine.combine and seg_scan,
    # and engine.prepare once; its exec time is the top-level seams'
    (root,) = sched.tracer.tree(job.id)["spans"]
    stack, costs = [root], []
    while stack:
        node = stack.pop()
        stack.extend(node["children"])
        if node["name"] == "device_cost":
            costs.append(node["attrs"])
    (cost,) = costs
    assert cost["kernel_calls"] == 4 * SUPERSTEPS + 1
    seams = ks["engine.prepare"]["exec_s"] + ks["engine.superstep"]["exec_s"]
    assert cost["exec_ms_share"] == pytest.approx(seams * 1e3, abs=2e-3)


def test_answers_bit_equal_with_profiling_and_tracing_on_and_off(
        snap, clean_profilers):
    specs = _bfs_specs(snap) + [_dense_spec(snap)]
    _, on, _ = _serve(snap, specs, on=True)
    _, off, _ = _serve(snap, specs, on=False)
    for a, b in zip(on, off):
        assert a.state.value == b.state.value == "done"
        assert set(a.result) == set(b.result)
        for key, va in a.result.items():
            vb = b.result[key]
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype and np.array_equal(
                    va.view(np.uint8), vb.view(np.uint8)), key
            else:
                assert va == vb, key


def test_nothing_is_made_while_no_profiler_is_installed(
        snap, clean_profilers, monkeypatch):
    made = {"range": 0, "event": 0, "clock": 0}

    def counting(name, real):
        def f(*a, **kw):
            made[name] += 1
            return real(*a, **kw)
        return f
    # a session "recording" would make every measured seam open a range
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting("range",
                                 torch.autograd.profiler.record_function))
    monkeypatch.setattr(torch.cuda, "Event",
                        counting("event", torch.cuda.Event))
    monkeypatch.setattr(devprof, "time", types.SimpleNamespace(
        perf_counter=counting("clock", time.perf_counter),
        time=counting("clock", time.time)))
    shared = devprof.stage("serving.result")
    assert shared is devprof.stage("serving.wait") \
        is devprof.seam("engine.gather", torch.device("cpu"))
    with shared as entered:
        assert entered is None
    _, jobs, _ = _serve(snap, _bfs_specs(snap) + [_dense_spec(snap)],
                        on=False)
    assert all(j.state.value == "done" for j in jobs)
    assert made == {"range": 0, "event": 0, "clock": 0}


def _annotations(trace: dict) -> dict:
    """``user_annotation`` ranges by name: ``(start, end, tid)`` on the
    host's wall clock."""
    base = float(trace.get("baseTimeNanoseconds", 0)) / 1e9
    out: dict = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            a = base + float(e["ts"]) / 1e6
            out.setdefault(e["name"], []).append(
                (a, a + float(e["dur"]) / 1e6, e.get("tid")))
    return out


def _inside(inner, outer) -> bool:
    return any(a <= x and y <= b for x, y, _ in inner
               for a, b, _ in outer) and all(
        any(a <= x and y <= b for a, b, _ in outer) for x, y, _ in inner)


def test_stages_lie_in_the_profiler_trace(snap, clean_profilers, tmp_path):
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        sched, jobs, ks = _serve(snap, _bfs_specs(snap)
                                 + [_dense_spec(snap)])
    prof.export_chrome_trace(str(path))
    got = _annotations(json.loads(path.read_text()))
    for key in DEVICE + ("serving.result",):
        assert len(got.get(key, ())) == ks[key]["calls"], key
    # the worker waits and dispatches on until the scheduler closes
    for key in ("serving.wait", "serving.dispatch"):
        assert len(got.get(key, ())) >= ks[key]["calls"], key
    # one thread, the scheduler's worker, opened them all
    assert len({t for key in DEVICE + HOST for *_, t in got[key]}) == 1
    # on the trace's own clock: the engine's gather and combine inside
    # its supersteps, the BFS kernels inside the sweeps
    assert _inside(got["engine.gather"], got["engine.superstep"])
    assert _inside(got["engine.combine"], got["engine.superstep"])
    assert _inside(got["frontier_round"], got["bfs_batched.sweep"])
    # each inside the run that made it: the BFS seams inside the batch's
    # run span, the engine's inside the dense job's, and each result
    # inside its job's attempt (the tracer's host clock; 5 ms of slack
    # for the two clocks' offset)
    slack = 5e-3

    def span(job, name):
        nodes = [sched.tracer.tree(job.id)["spans"][0]]
        while nodes:
            node = nodes.pop()
            if node["name"] == name:
                return [(node["start"] - slack, node["end"] + slack,
                         None)]
            nodes.extend(node["children"])
        raise KeyError(name)
    bfs, dense = jobs[0], jobs[-1]
    for key in DEVICE[:3]:
        assert _inside(got[key], span(bfs, "run")), key
    for key in DEVICE[3:]:
        assert _inside(got[key], span(dense, "run")), key
    results = sorted(got["serving.result"])
    assert _inside(results[:1], span(bfs, "attempt"))
    assert _inside(results[1:], span(dense, "attempt"))
