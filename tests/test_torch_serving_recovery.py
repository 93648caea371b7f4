"""Recovery through the port's scheduler against the JAX package's: a
BFS batch, an SSSP cohort and a DenseProgram crash on their first attempt
(``FaultPlan``), retry, resume from their checkpoints and finish
bit-equal to uninterrupted runs, with the same recovery counters in both
packages; a checkpoint the JAX scheduler wrote is resumed by the port's.
Then the retry policy and lifecycle with host callables (no kernels)."""

import threading
import time

import numpy as np
import pytest

import titan_tpu.models.pagerank as JPR
import titan_tpu.olap.api as JA
import titan_tpu.olap.recovery as JREC
import titan_tpu.olap.serving.scheduler as JSCH
import titan_tpu.utils.metrics as JM
import titan_tpu_torch.models.pagerank as PPR
import titan_tpu_torch.olap.api as PA
import titan_tpu_torch.olap.recovery as PREC
import titan_tpu_torch.olap.serving.scheduler as PSCH
import titan_tpu_torch.utils.metrics as PM
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu_torch.models import bfs_hybrid as P
from titan_tpu_torch.models import frontier as FR
from titan_tpu_torch.olap import engine as E
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.serving.jobs import JobState

N, M, SEED = 192, 900, 42
WAIT = 120
PKG = {"jax": (JA, JREC, JPR), "port": (PA, PREC, PPR)}
RECOVERY = ["serving.recovery.resumes", "serving.recovery.rounds_replayed",
            "serving.recovery.retries", "serving.recovery.checkpoints",
            "serving.recovery.retries_exhausted", "serving.jobs.completed",
            "serving.jobs.failed"]


@pytest.fixture(scope="module")
def snaps():
    rng = np.random.default_rng(SEED)
    s = rng.integers(0, N, M).astype(np.int32)
    d = rng.integers(0, N, M).astype(np.int32)
    src, dst = np.concatenate([s, d]), np.concatenate([d, s])
    return JS.from_arrays(N, src, dst), PS.from_arrays(N, src, dst)


def _sched(which, snap, ckdir, **kw):
    kw.setdefault("autostart", False)
    if which == "jax":
        return JSCH.JobScheduler(snapshot=snap, metrics=JM.MetricManager(),
                                 checkpoint_dir=str(ckdir),
                                 hbm_budget_bytes=1e12, **kw)
    return PSCH.JobScheduler(snapshot=snap, metrics=PM.MetricManager(),
                             checkpoint_dir=str(ckdir),
                             hbm_budget_bytes=1e12, device="cpu", **kw)


def _serve(which, snap, ckdir, make_specs):
    sched = _sched(which, snap, ckdir)
    try:
        jobs = [sched.submit(s) for s in make_specs(*PKG[which], snap)]
        sched.start()
        for j in jobs:
            assert j.wait(WAIT), j
        deadline = time.time() + 30
        while time.time() < deadline and sched._metrics.counter_value(
                "serving.jobs.completed") + sched._metrics.counter_value(
                "serving.jobs.failed") < len(jobs):
            time.sleep(0.01)
        return jobs, {n: sched._metrics.counter_value(n) for n in RECOVERY}
    finally:
        sched.close()


def _inv(snap):
    return np.where(snap.out_degree > 0,
                    1.0 / np.maximum(snap.out_degree, 1), 0.0) \
        .astype(np.float32)


def _crashing_stream(api, rec, prog, snap):
    nz = np.flatnonzero(snap.out_degree > 0)
    bfs = [api.JobSpec(kind="bfs", params={
        "source_dense": int(nz[i]),
        **({"faults": rec.FaultPlan(crash_at_round=2)} if i == 0 else {})},
        checkpoint_every=1, max_retries=1, retry_backoff_s=0.01)
        for i in range(3)]
    dense = api.JobSpec(kind="dense", params={
        "program": prog.PageRank(0.85, 20, 0.0), "n": snap.n,
        "inv_outdeg": _inv(snap),
        "faults": rec.FaultPlan(crash_at_round=10)},
        checkpoint_every=5, max_retries=1, retry_backoff_s=0.01)
    sssp = [api.JobSpec(kind="sssp", params={
        "source_dense": int(nz[4 + i]),
        **({"faults": rec.FaultPlan(crash_at_round=3)} if i == 0 else {})},
        checkpoint_every=2, max_retries=1, retry_backoff_s=0.01)
        for i in range(2)]
    return bfs + [dense] + sssp


@pytest.fixture(scope="module")
def crashed(snaps, tmp_path_factory):
    js, ps = snaps
    return (_serve("jax", js, tmp_path_factory.mktemp("j"),
                   _crashing_stream),
            _serve("port", ps, tmp_path_factory.mktemp("p"),
                   _crashing_stream))


def test_recovered_jobs_equal_uninterrupted_runs(crashed, snaps):
    _, ps = snaps
    (jj, _), (pj, _) = crashed
    assert [j.state.value for j in pj] == [j.state.value for j in jj] == \
        ["done"] * 6
    # the batch failed as one (a worker death): every BFS member retried
    assert [j.attempt for j in pj] == [j.attempt for j in jj] == \
        [2, 2, 2, 2, 2, 2]
    for i in range(3):
        ref, _ = P.frontier_bfs_hybrid(
            ps, int(pj[i].spec.params["source_dense"]), device="cpu")
        assert np.array_equal(pj[i].result["dist"], ref)
        assert np.array_equal(pj[i].result["dist"], jj[i].result["dist"])
    direct = E.run_single(PPR.PageRank(0.85, 20, 0.0), ps,
                          {"n": ps.n, "inv_outdeg": _inv(ps)}, device="cpu")
    assert pj[3].result["iterations"] == 20
    assert np.array_equal(pj[3].result["rank"], direct["rank"])
    np.testing.assert_allclose(pj[3].result["rank"], jj[3].result["rank"],
                               rtol=1e-5)
    for i in (4, 5):
        d, r = FR.frontier_sssp(ps, int(pj[i].spec.params["source_dense"]),
                                device="cpu")
        assert np.array_equal(pj[i].result["dist"], d)
        assert pj[i].result["rounds"] == r
        assert np.array_equal(pj[i].result["dist"], jj[i].result["dist"])


def test_recovery_counters_equal_jax(crashed):
    (jj, jc), (pj, pc) = crashed
    assert pc == jc
    assert [(j.rounds_replayed, j.checkpoint_round is not None)
            for j in pj] == [(j.rounds_replayed,
                              j.checkpoint_round is not None) for j in jj]
    assert pc["serving.recovery.retries"] == 6
    # the dense job resumed from superstep 5, replaying 5
    assert pj[3].rounds_replayed == 5


def test_a_jax_checkpoint_is_resumed_by_the_port(snaps, tmp_path):
    """The JAX scheduler's BFS job dies at level 3 with no retries left,
    leaving checkpoints under its idempotency key; the port's scheduler,
    on the same store, adopts the newest one on its first attempt."""
    js, ps = snaps
    src = int(np.flatnonzero(ps.out_degree > 0)[2])
    jobs, _ = _serve("jax", js, tmp_path, lambda api, rec, prog, snap: [
        api.JobSpec(kind="bfs", params={
            "source_dense": src,
            "faults": rec.FaultPlan(crash_at_round=3)},
            checkpoint_every=1, idempotency_key="logical-7")])
    assert jobs[0].state.value == "failed"
    pjobs, pc = _serve("port", ps, tmp_path, lambda api, rec, prog, snap: [
        api.JobSpec(kind="bfs", params={"source_dense": src},
                    checkpoint_every=1, idempotency_key="logical-7")])
    (j,) = pjobs
    assert j.state.value == "done" and j.attempt == 1
    assert pc["serving.recovery.resumes"] == 1
    ref, _ = P.frontier_bfs_hybrid(ps, src, device="cpu")
    assert np.array_equal(j.result["dist"], ref)
    assert j.trace is not None
    (root,) = j.trace.tracer.tree(j.id)["spans"]
    names = []

    def walk(node):
        names.append(node["name"])
        for c in node["children"]:
            walk(c)
    walk(root)
    assert "resume" in names


# --------------------------------------------------------------------------
# retry policy and lifecycle (host callables only)
# --------------------------------------------------------------------------

@pytest.fixture
def sched(snaps):
    s = PSCH.JobScheduler(snapshot=snaps[1], metrics=PM.MetricManager(),
                          device="cpu", hbm_budget_bytes=1e12)
    try:
        yield s
    finally:
        s.close()


def _flaky(n_failures, calls):
    def fn():
        calls.append(time.time())
        if len(calls) <= n_failures:
            raise RuntimeError(f"boom #{len(calls)}")
        return 41 + len(calls)
    return fn


def test_retry_then_done(sched):
    calls = []
    job = sched.submit(PA.JobSpec(kind="callable",
                                  params={"fn": _flaky(1, calls)},
                                  max_retries=2, retry_backoff_s=0.01))
    assert job.wait(WAIT) and job.state is JobState.DONE
    assert job.attempt == 2 and job.result["value"] == 43
    assert sched._metrics.counter_value("serving.recovery.retries") == 1


def test_retries_exhausted_goes_failed(sched):
    calls = []
    job = sched.submit(PA.JobSpec(kind="callable",
                                  params={"fn": _flaky(99, calls)},
                                  max_retries=2, retry_backoff_s=0.01))
    assert job.wait(WAIT) and job.state is JobState.FAILED
    assert job.attempt == 3 and "boom #3" in job.error
    deadline = time.time() + 30
    while time.time() < deadline and sched._metrics.counter_value(
            "serving.recovery.retries_exhausted") < 1:
        time.sleep(0.01)
    assert sched._metrics.counter_value(
        "serving.recovery.retries_exhausted") == 1


def test_cancel_while_retrying(sched):
    calls = []
    job = sched.submit(PA.JobSpec(kind="callable",
                                  params={"fn": _flaky(99, calls)},
                                  max_retries=3, retry_backoff_s=30.0))
    deadline = time.time() + WAIT
    while time.time() < deadline and job.state is not JobState.RETRYING:
        time.sleep(0.01)
    assert job.state is JobState.RETRYING
    assert sched.cancel(job.id) and job.state is JobState.CANCELLED
    assert len(calls) == 1


def test_close_fails_queued_jobs_and_joins_the_worker(snaps):
    s = PSCH.JobScheduler(snapshot=snaps[1], metrics=PM.MetricManager(),
                          device="cpu", hbm_budget_bytes=1e12)
    gate = threading.Event()
    try:
        busy = s.submit(PA.JobSpec(kind="callable",
                                   params={"fn": lambda: gate.wait(30)}))
        queued = s.submit(PA.JobSpec(kind="callable",
                                     params={"fn": lambda: 1}))
        deadline = time.time() + WAIT
        while time.time() < deadline and busy.state is not JobState.RUNNING:
            time.sleep(0.01)
        assert busy.state is JobState.RUNNING
    finally:
        gate.set()
        s.close()
    assert not s._worker.is_alive()
    assert busy.state is JobState.DONE
    assert queued.state in (JobState.DONE, JobState.FAILED)
    if queued.state is JobState.FAILED:
        assert "closed" in queued.error


def test_close_raises_while_a_batch_still_runs(snaps):
    s = PSCH.JobScheduler(snapshot=snaps[1], metrics=PM.MetricManager(),
                          device="cpu", hbm_budget_bytes=1e12)
    gate = threading.Event()
    busy = s.submit(PA.JobSpec(kind="callable",
                               params={"fn": lambda: gate.wait(30)}))
    deadline = time.time() + WAIT
    while time.time() < deadline and busy.state is not JobState.RUNNING:
        time.sleep(0.01)
    try:
        with pytest.raises(RuntimeError, match="still running"):
            s.close(timeout=0.05)
    finally:
        gate.set()
        s._worker.join(WAIT)
    assert not s._worker.is_alive()
