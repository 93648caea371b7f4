"""The serving layer's parts one by one: the device-memory ledger, the
pool, the job state machine, the batch key, the device default, what is
not ported yet (each refusal names its ROADMAP item), the computer's
``run_async`` and the kernel-library build under two threads."""

import shutil
import threading
import time

import numpy as np
import pytest
import torch

import titan_tpu.olap.api as JA
import titan_tpu.olap.serving.batcher as JB
import titan_tpu.olap.serving.hbm as JH
import titan_tpu_torch.olap.api as PA
import titan_tpu_torch.olap.serving.batcher as PB
import titan_tpu_torch.olap.serving.hbm as PH
from titan_tpu_torch import build
from titan_tpu_torch.olap import engine as E
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.serving import JobScheduler, JobState
from titan_tpu_torch.olap.serving.jobs import Job
from titan_tpu_torch.olap.serving.pool import SnapshotPool
from titan_tpu_torch.utils.metrics import MetricManager

WAIT = 60


def _snap(n=64, m=200, seed=1):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, m)
    d = rng.integers(0, n, m)
    return PS.from_arrays(n, np.concatenate([s, d]), np.concatenate([d, s]))


# --------------------------------------------------------------------------
# hbm
# --------------------------------------------------------------------------

def test_ledger_reserve_pin_evict_release():
    evicted = []
    led = PH.HBMLedger(1000, on_evict=evicted.append, device="cpu")
    led.reserve("a", 400)
    led.reserve("b", 500)
    assert led.resident_bytes() == 900 and led.pinned_bytes() == 900
    with pytest.raises(PH.AdmissionError, match="pinned"):
        led.reserve("c", 200)                # everything is pinned
    led.unpin("a")
    led.reserve("c", 200)                    # evicts idle a
    assert evicted == ["a"] and led.resident_bytes() == 700
    led.reserve("b", 500)                    # existing key: one more pin
    led.unpin("b")
    assert led.pinned_bytes() == 700         # b still pinned once
    led.unpin("b")
    led.unpin("c")
    led.reserve("d", 900)                    # largest idle first: b, c
    assert evicted == ["a", "b", "c"]
    led.release("d")
    assert led.resident_bytes() == 0
    with pytest.raises(PH.AdmissionError, match="needs"):
        led.reserve("huge", 2000)


def test_ledger_matches_the_jax_ledger():
    def run(mod, **kw):
        ev = []
        led = mod.HBMLedger(1000, on_evict=ev.append, **kw)
        out = []
        for k, b in (("a", 300), ("b", 600), ("c", 200)):
            try:
                led.reserve(k, b)
            except mod.AdmissionError:
                out.append(("refused", k))
            led.unpin(k)
        led.reserve("d", 700)
        return out, ev, led.resident_bytes(), led.pinned_bytes()
    assert run(PH, device="cpu") == run(JH)


def test_byte_model_equals_the_jax_package():
    snap = _snap()
    assert PH.snapshot_csr_bytes(snap) == JH.snapshot_csr_bytes(snap)
    assert PH.chunked_csr_bytes(10, 7) == JH.chunked_csr_bytes(10, 7)
    hg = {"n": 10, "q_total": 7}
    assert PH.graph_bytes(hg) == JH.graph_bytes(hg)


def test_default_budget(monkeypatch):
    assert PH.default_budget_bytes("cpu") == float("inf")
    assert PH.HBMLedger(device="cpu").budget_bytes == float("inf")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (10, 80 * 2**30))
    assert PH.default_budget_bytes() == 0.75 * 80 * 2**30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PH.HBMLedger()


def test_device_graph_cache_loads_once_and_evicts():
    cache = PH.DeviceGraphCache(budget_bytes=PH.chunked_csr_bytes(10, 5)
                                + 1, device="cpu")
    loads = []

    def loader(q):
        def f():
            loads.append(q)
            return {"n": 10, "q_total": q}
        return f
    hg, g, _, _ = cache.get_or_load("x", loader(5), lambda h: ("dev", h))
    again = cache.get_or_load("x", loader(5), lambda h: ("dev", h))
    assert again[:2] == (hg, g) and again[2:] == (0.0, 0.0)
    cache.get_or_load("y", loader(4), lambda h: ("dev", h))
    assert "x" not in cache and "y" in cache and loads == [5, 4]


# --------------------------------------------------------------------------
# pool, jobs, batch key
# --------------------------------------------------------------------------

def test_pool_leases_the_fixed_snapshot():
    snap = _snap()
    pool = SnapshotPool(snapshot=snap)
    with pool.acquire(labels=["x"], directed=True) as s:
        assert s is snap and pool.stats()["active_leases"] == 1
        lease = pool.acquire()
        assert pool.stats()["active_leases"] == 2
        lease.release()
        lease.release()                      # exactly once
    assert pool.stats() == {"entries": 0, "snapshots": 1,
                            "active_leases": 0, "retired": 0}
    pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.acquire()


@pytest.mark.parametrize("kw,item", [
    ({"graph": object()}, "6b"), ({"live": object()}, "item 7")])
def test_pool_refuses_what_is_not_ported(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        SnapshotPool(snapshot=_snap(), **kw)


@pytest.mark.parametrize("kw,item", [
    ({"mesh": object()}, "item 9"), ({"live": object()}, "item 7"),
    ({"graph": object(), "snapshot": None}, "6b")])
def test_scheduler_refuses_what_is_not_ported(kw, item):
    kw.setdefault("snapshot", _snap())
    with pytest.raises(NotImplementedError, match=item):
        JobScheduler(device="cpu", autostart=False, **kw)


def test_interactive_lane_names_its_roadmap_item():
    s = JobScheduler(snapshot=_snap(), device="cpu", autostart=False)
    try:
        with pytest.raises(NotImplementedError, match="item 8"):
            s.interactive()
    finally:
        s.close()
    with pytest.raises(NotImplementedError, match="item 9"):
        PB.Batcher(mesh=object(), device="cpu")


def test_scheduler_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JobScheduler(snapshot=_snap(), autostart=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PB.Batcher()


def test_job_state_machine_equals_the_jax_jobs():
    import titan_tpu.olap.serving.jobs as JJ
    import titan_tpu_torch.olap.serving.jobs as PJ

    def run(jobs_mod, api):
        out = []
        j = jobs_mod.Job(api.JobSpec(kind="bfs", max_retries=1,
                                     retry_backoff_s=0.0))
        out.append(j.start())
        out.append(j.fail("x"))
        out.append(j.state.value)
        out.append(j.start())
        out.append(j.fail("y"))
        out.append((j.state.value, j.attempt, j.retries_exhausted))
        out.append(j.complete({}))
        c = jobs_mod.Job(api.JobSpec(kind="wcc", tenant=""))
        out.append((c.cancel(), c.state.value, c.tenant))
        r = jobs_mod.Job(api.JobSpec(kind="sssp"))
        r.start()
        out.append((r.cancel(), r.state.value, r.cancel_requested))
        out.append((r.mark_cancelled(), r.state.value))
        wire = r.to_wire()
        out.append(sorted(k for k in wire if k not in ("job",)))
        e = jobs_mod.Job(api.JobSpec(kind="bfs"))
        out.append((e.expire(), e.state.value, e.state.terminal))
        return out
    assert run(PJ, PA) == run(JJ, JA)


def test_batch_key_equals_the_jax_batch_key():
    specs = [dict(kind="bfs"), dict(kind="bfs", params={"max_levels": 3}),
             dict(kind="bfs", labels=["a"]), dict(kind="bfs", directed=True),
             dict(kind="sssp", params={"delta": 0.5}),
             dict(kind="sssp", params={"quantile_mass": "x"}),
             dict(kind="wcc"), dict(kind="pagerank"), dict(kind="dense"),
             dict(kind="callable")]
    for kw in specs:
        assert PB.batch_key(PA.JobSpec(**kw)) == \
            JB.batch_key(JA.JobSpec(**kw)), kw


def test_jobspec_fields_equal_the_jax_jobspec():
    import dataclasses
    pf = [(f.name, f.default) for f in dataclasses.fields(PA.JobSpec)]
    jf = [(f.name, f.default) for f in dataclasses.fields(JA.JobSpec)]
    assert pf == jf
    assert PA.JobSpec(kind="bfs").directed is False
    assert PA.EdgeData().values == {}


# --------------------------------------------------------------------------
# the computer's scheduler
# --------------------------------------------------------------------------

def test_computer_run_async_submits_to_its_scheduler():
    snap = _snap()
    comp = E.GPUGraphComputer(snapshot=snap, device="cpu")
    sched = comp.scheduler(metrics=MetricManager(), hbm_budget_bytes=1e12)
    try:
        assert comp.scheduler() is sched and sched.device.type == "cpu"
        job = comp.run_async(PA.JobSpec(kind="wcc"))
        assert job.wait(WAIT) and job.state is JobState.DONE
        assert job.result["components"] >= 1
    finally:
        sched.close()
    assert comp.scheduler(metrics=MetricManager()) is not sched
    comp.scheduler().close()


def test_job_ids_are_unique_across_threads():
    ids, lock = [], threading.Lock()

    def make():
        for _ in range(200):
            j = Job(PA.JobSpec(kind="callable"))
            with lock:
                ids.append(j.id)
    ts = [threading.Thread(target=make) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT)
    assert not any(t.is_alive() for t in ts)
    assert len(set(ids)) == 800


# --------------------------------------------------------------------------
# build.py: one library built from two threads at once
# --------------------------------------------------------------------------

@pytest.mark.skipif(shutil.which("cc") is None and shutil.which("gcc") is
                    None, reason="needs a C compiler")
def test_two_threads_build_one_library_once(tmp_path, monkeypatch):
    cc = shutil.which("cc") or shutil.which("gcc")
    src = tmp_path / "k.c"
    src.write_text("int tt_k(void) { return 7; }\n")
    compiles, outs, errors = [], [], []
    real = build.subprocess.run

    def slow_run(cmd, **kw):
        compiles.append(cmd)
        time.sleep(0.2)                # both threads arrive meanwhile
        return real(cmd, **kw)
    monkeypatch.setattr(build.subprocess, "run", slow_run)
    barrier = threading.Barrier(2)

    def go():
        try:
            barrier.wait(WAIT)
            outs.append(build.build_shared(str(src), [cc, "-shared",
                                                      "-fPIC"],
                                           str(tmp_path / "b"), "k"))
        except Exception as e:          # reported below
            errors.append(e)
    ts = [threading.Thread(target=go) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT)
    assert not any(t.is_alive() for t in ts)
    assert errors == []
    assert len(compiles) == 1 and outs[0] == outs[1]
    import ctypes
    assert ctypes.CDLL(outs[0]).tt_k() == 7
    assert not list((tmp_path / "b").glob("*.tmp"))
