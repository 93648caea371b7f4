"""The port's checkpoint plane (``titan_tpu_torch.olap.recovery`` and the
engine's chunked ``run_single`` / ``GPUGraphComputer.run(resume_from=,
checkpoint_to=, checkpoint_every=)``) and its classic MapReduce stages,
on the CPU, against the JAX package's.

The store tests mirror ``tests/test_recovery.py``'s. The on-disk format
is the JAX package's byte for byte, so a checkpoint either package
writes loads in the other, bit-equal. Chunked and resumed engine runs
are bit-equal to the uninterrupted port run (each superstep depends
only on the state and the absolute iteration) and fire at the same
boundary rounds as the JAX ``run_single``. Graph: the repo-shared
n=192/m=900/seed-42 symmetric snapshot of ``tests/test_recovery.py``.
BFS is exact against JAX; PageRank is held at rtol 1e-5 (float32 sums in
scan order here, scatter order in JAX), the tolerance of
``test_torch_engine.py``.
"""

import filecmp
import os

import numpy as np
import pytest

import titan_tpu.models.bfs as jbfs
import titan_tpu.models.pagerank as jpr
import titan_tpu.olap.recovery as JR
import titan_tpu_torch.models.bfs as pbfs
import titan_tpu_torch.models.pagerank as ppr
import titan_tpu_torch.olap.recovery as PR
from titan_tpu.olap.api import MapReduce as JMapReduce
from titan_tpu.olap.tpu import engine as JE
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu_torch.olap import engine as PE
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.api import MapReduce

_N = 192
RTOL = 1e-5


@pytest.fixture(scope="module")
def snaps():
    rng = np.random.default_rng(42)
    src = rng.integers(0, _N, 900).astype(np.int32)
    dst = rng.integers(0, _N, 900).astype(np.int32)
    js = JS.from_arrays(_N, np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
    return js, PS.from_numpy(js)


def _source(snap) -> int:
    return int(np.flatnonzero(snap.out_degree > 0)[0])


def _inv(snap):
    outdeg = np.maximum(snap.out_degree, 1).astype(np.float32)
    return np.where(snap.out_degree > 0, 1.0 / outdeg, 0.0).astype(
        np.float32)


def _programs(snap):
    """(name, JAX program, port program, params): an integer and a float
    program."""
    return [("bfs", jbfs.BFS(max_iterations=100), pbfs.BFS(max_iterations=100),
             {"source_dense": _source(snap)}),
            ("pagerank", jpr.PageRank(iterations=20),
             ppr.PageRank(iterations=20),
             {"n": snap.n, "inv_outdeg": _inv(snap)})]


def _same(a, b):
    assert a.iterations == b.iterations
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# store: manifest + digests + atomic commit
# --------------------------------------------------------------------------

def test_store_roundtrip_and_ordering(tmp_path):
    st = PR.CheckpointStore(str(tmp_path))
    a1 = {"dist": np.arange(16, dtype=np.int32)}
    st.save("j1", attempt=1, round_=10, kind="bfs", arrays=a1,
            meta={"epoch": 3})
    st.save("j1", attempt=2, round_=5, kind="bfs",
            arrays={"dist": np.arange(16, dtype=np.int32) * 2})
    ck = st.latest("j1")
    assert (ck.attempt, ck.round) == (2, 5)
    assert (ck.arrays["dist"] == np.arange(16, dtype=np.int32) * 2).all()
    assert st.latest("j2") is None
    ck1 = st.load(st.checkpoints("j1")[0])
    assert ck1.meta == {"epoch": 3} and ck1.kind == "bfs"


def test_store_objects_payload_roundtrip(tmp_path):
    st = PR.CheckpointStore(str(tmp_path))
    payload = {"states": {1: {"n": 2}}, "memory": {"x": 1.5}}
    st.save("j1", attempt=1, round_=2, kind="host", objects=payload)
    assert st.latest("j1").objects == payload


def test_store_detects_torn_and_corrupt_writes(tmp_path):
    metrics = PR.Counters()
    st = PR.CheckpointStore(str(tmp_path), metrics=metrics)
    p1 = st.save("j1", attempt=1, round_=1, kind="bfs",
                 arrays={"dist": np.arange(64, dtype=np.int32)})
    p2 = st.save("j1", attempt=1, round_=2, kind="bfs",
                 arrays={"dist": np.arange(64, dtype=np.int32) + 1})
    os.makedirs(os.path.join(str(tmp_path), "j1",
                             ".tmp-ckpt-a0001-r00000003-999"))
    assert st.latest("j1").round == 2
    PR.FaultPlan.corrupt(p2)
    assert not st.validate(p2)
    with pytest.raises(PR.CheckpointInvalid):
        st.load(p2)
    assert st.latest("j1").round == 1
    PR.FaultPlan.corrupt(p1)
    assert st.latest("j1") is None
    assert metrics.counts == {"serving.recovery.checkpoints": 2,
                              "serving.recovery.checkpoint_bytes": 512,
                              "serving.recovery.invalid_checkpoints": 3}
    assert len(metrics.samples["serving.recovery.checkpoint_ms"]) == 2


def test_store_detects_manifest_garble(tmp_path):
    st = PR.CheckpointStore(str(tmp_path))
    p = st.save("j1", attempt=1, round_=1, kind="bfs",
                arrays={"dist": np.zeros(8, np.int32)})
    with open(os.path.join(p, "manifest.json"), "w") as f:
        f.write("{not json")
    assert st.latest("j1") is None


def test_fault_plan_is_deterministic(snaps):
    assert PR.FaultPlan.seeded(7, 10) == PR.FaultPlan.seeded(7, 10)
    assert PR.FaultPlan.seeded(7, 10).crash_at_round == \
        JR.FaultPlan.seeded(7, 10).crash_at_round
    plan = PR.FaultPlan(crash_at_round=3)
    plan.check(2, attempt=1)
    with pytest.raises(PR.InjectedFault):
        plan.check(3, attempt=1)
    plan.check(3, attempt=2)
    _, ps = snaps
    PE.device_graph(ps, "cpu")
    with pytest.raises(PR.SnapshotEvicted):
        PR.FaultPlan(evict_at_round=1).check(1, attempt=1, snapshot=ps)
    assert ps._device_graphs == {}       # the next run uploads again


def test_job_recovery_cadence_faults_and_metrics(tmp_path):
    class Job:
        id, attempt, last_round = "job-1", 1, 7
        checkpoint_round = rounds_replayed = 0

    metrics = PR.Counters()
    job = Job()
    rec = PR.JobRecovery(PR.CheckpointStore(str(tmp_path)), job, every=3,
                         faults=PR.FaultPlan(corrupt_at_round=6),
                         metrics=metrics)
    assert [r for r in range(10) if rec.due(r)] == [3, 6, 9]
    rec.save(3, {"x": np.ones(4, np.float32)}, kind="dense")
    rec.save(6, {"x": np.zeros(4, np.float32)}, kind="dense")
    assert job.checkpoint_round == 6
    ck = rec.latest(kind="dense")          # round 6 was corrupted
    assert ck.round == 3 and rec.latest(kind="bfs") is None
    rec.resumed(ck.round)
    assert job.rounds_replayed == 4
    assert metrics.counts == {"serving.recovery.resumes": 1,
                              "serving.recovery.rounds_replayed": 4}
    assert PR.JobRecovery(None, job).latest(kind="dense") is None


# --------------------------------------------------------------------------
# cross-package: one on-disk format
# --------------------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(5)
    return {"dist": rng.integers(0, 1 << 30, 300).astype(np.int32),
            "rank": rng.random(300).astype(np.float32),
            "alive": rng.random((3, 7)) < 0.5}


def test_both_stores_write_the_same_bytes(tmp_path):
    for root, store in (("jax", JR.CheckpointStore), ("port",
                                                       PR.CheckpointStore)):
        store(str(tmp_path / root)).save("run", attempt=2, round_=12,
                                         kind="dense", arrays=_arrays(),
                                         meta={"epoch": 1})
    a = tmp_path / "jax" / "run" / "ckpt-a0002-r00000012"
    b = tmp_path / "port" / "run" / "ckpt-a0002-r00000012"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) == \
        ["alive.npy", "dist.npy", "manifest.json", "rank.npy"]
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == errors == []


@pytest.mark.parametrize("writer,reader", [
    (JR.CheckpointStore, PR.CheckpointStore),
    (PR.CheckpointStore, JR.CheckpointStore)])
def test_each_package_loads_the_others_checkpoints(tmp_path, writer, reader):
    w = writer(str(tmp_path))
    w.save("j", attempt=1, round_=4, kind="dense", arrays=_arrays())
    w.save("j", attempt=1, round_=8, kind="dense",
           arrays={k: v[::-1].copy() for k, v in _arrays().items()})
    r = reader(str(tmp_path))
    ck = r.latest("j")
    assert (ck.job_id, ck.attempt, ck.round, ck.kind) == ("j", 1, 8, "dense")
    for k, v in _arrays().items():
        assert ck.arrays[k].dtype == v.dtype
        np.testing.assert_array_equal(ck.arrays[k], v[::-1])
    JR.FaultPlan.corrupt(r.checkpoints("j")[-1])
    assert r.latest("j").round == 4 and w.latest("j").round == 4


# --------------------------------------------------------------------------
# the engine: chunked run_single, resume, GPUGraphComputer.run
# --------------------------------------------------------------------------

@pytest.mark.parametrize("every", [1, 3, 7])
@pytest.mark.parametrize("which", [0, 1], ids=["bfs", "pagerank"])
def test_chunked_run_bit_equal_with_jax_boundaries(snaps, every, which):
    js, ps = snaps
    _, jprog, pprog, params = _programs(ps)[which]
    ref = PE.run_single(pprog, ps, params, device="cpu")
    pcaps, jcaps = {}, {}
    got = PE.run_single(pprog, ps, params, device="cpu",
                        checkpoint=lambda it, st: pcaps.__setitem__(
                            it, {k: v.numpy() for k, v in st.items()}),
                        checkpoint_every=every)
    _same(got, ref)
    jref = JE.run_single(jprog, js, params,
                         checkpoint=lambda it, st: jcaps.__setitem__(
                             it, {k: np.asarray(v) for k, v in st.items()}),
                         checkpoint_every=every)
    assert sorted(pcaps) == sorted(jcaps)
    assert max(pcaps) == ref.iterations == jref.iterations
    # each boundary state resumes to the uninterrupted result; from the
    # last, a converged run re-detects its convergence one superstep on,
    # in both packages
    bounds = sorted(pcaps)
    for it in bounds[:2] + bounds[-1:]:
        res = PE.run_single(pprog, ps, params, device="cpu",
                            resume={"state": pcaps[it], "iteration": it})
        jres = JE.run_single(jprog, js, params,
                             resume={"state": jcaps[it], "iteration": it})
        assert res.iterations == jres.iterations
        for k in ref:
            np.testing.assert_array_equal(res[k], ref[k])
        if it < bounds[-1]:
            assert res.iterations == ref.iterations


def test_checkpoint_gets_a_copy(snaps):
    """The callback's arrays stay as they were when the loop goes on."""
    _, ps = snaps
    _, _, pprog, params = _programs(ps)[1]
    caps = {}
    PE.run_single(pprog, ps, params, device="cpu",
                  checkpoint=lambda it, st: caps.__setitem__(it, st),
                  checkpoint_every=5)
    first = caps[5]["rank"].clone()
    assert caps[5]["rank"] is not caps[10]["rank"]
    assert not np.array_equal(first.numpy(), caps[20]["rank"].numpy())
    assert np.array_equal(first.numpy(), caps[5]["rank"].numpy())


@pytest.mark.parametrize("which", [0, 1], ids=["bfs", "pagerank"])
def test_resume_from_a_jax_checkpoint(snaps, tmp_path, which):
    """A checkpoint directory the JAX computer wrote resumes in the port's
    to JAX's own resumed outputs and iteration count."""
    js, ps = snaps
    _, jprog, pprog, params = _programs(ps)[which]
    short_j = type(jprog)(max_iterations=3) if which == 0 \
        else jpr.PageRank(iterations=6)
    ckdir = str(tmp_path / "ck")
    jc = JE.TPUGraphComputer(snapshot=js, num_devices=1)
    jc.run(short_j, params, checkpoint_to=ckdir, checkpoint_every=2)
    assert [os.path.basename(p) for p in
            JR.CheckpointStore(ckdir).checkpoints("run")][-1] == \
        ("ckpt-a0001-r00000003" if which == 0 else "ckpt-a0001-r00000006")
    a = jc.run(jprog, params, resume_from=ckdir)
    b = PE.GPUGraphComputer(snapshot=ps, device="cpu").run(
        pprog, params, resume_from=ckdir)
    assert a.iterations == b.iterations
    for k in a:
        if which == 0:
            np.testing.assert_array_equal(b[k], a[k])
        else:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL)


def test_computer_resume_from_checkpoint_dir(snaps, tmp_path):
    """Mirrors the JAX package's test: a run cut by its iteration cap
    leaves checkpoints, the newest is corrupted, and the resumed full run
    falls back a round and still converges bit-equal; its own
    checkpoints are the next attempt's."""
    _, ps = snaps
    s = _source(ps)
    comp = PE.GPUGraphComputer(snapshot=ps, device="cpu")
    ref = PE.run_single(pbfs.BFS(max_iterations=100), ps,
                        {"source_dense": s}, device="cpu")
    ckdir = str(tmp_path / "run-ckpt")
    comp.run(pbfs.BFS(max_iterations=2), {"source_dense": s},
             checkpoint_to=ckdir, checkpoint_every=1)
    store = PR.CheckpointStore(ckdir)
    assert [os.path.basename(p) for p in store.checkpoints("run")] == \
        ["ckpt-a0001-r00000001", "ckpt-a0001-r00000002"]
    PR.FaultPlan.corrupt(store.checkpoints("run")[-1])
    got = comp.run(pbfs.BFS(max_iterations=100), {"source_dense": s},
                   resume_from=ckdir, checkpoint_to=ckdir,
                   checkpoint_every=2)
    _same(got, ref)
    ck = store.latest("run")
    assert (ck.attempt, ck.round, ck.kind) == (2, ref.iterations, "dense")
    # a kind the engine did not write is never resumed from
    other = str(tmp_path / "other")
    PR.CheckpointStore(other).save("run", attempt=1, round_=1, kind="bfs",
                                   arrays={"dist": ref["dist"]})
    _same(comp.run(pbfs.BFS(max_iterations=100), {"source_dense": s},
                   resume_from=other), ref)


# --------------------------------------------------------------------------
# classic MapReduce through the computer
# --------------------------------------------------------------------------

def _dist_histogram(base):
    class DistHistogram(base):
        memory_key = "levels"

        def map(self, vertex, emitter):
            emitter.emit(vertex.value("dist"), 1)

        def combine(self, key, values, emitter):
            emitter.emit(key, sum(values))

        def reduce(self, key, values, emitter):
            emitter.emit(key, sum(values))

        def finalize(self, results):
            return {k: v[0] for k, v in sorted(results.items())}
    return DistHistogram


def _id_list(base):
    class Reached(base):
        memory_key = "reached"

        def map(self, vertex, emitter):
            if vertex.get_state("dist") < 3:
                emitter.emit("ids", vertex.id)
            assert vertex.get_state("missing", 9) == 9
    return Reached


def test_classic_map_reduce_matches_jax(snaps):
    js, ps = snaps
    params = {"source_dense": _source(ps)}
    a = JE.TPUGraphComputer(snapshot=js, num_devices=1).run(
        jbfs.BFS(), params, map_reduces=[_dist_histogram(JMapReduce)(),
                                         _id_list(JMapReduce)()])
    b = PE.GPUGraphComputer(snapshot=ps, device="cpu").run(
        pbfs.BFS(), params, map_reduces=[_dist_histogram(MapReduce)(),
                                         _id_list(MapReduce)()])
    assert b.memory == a.memory
    levels, counts = np.unique(b["dist"], return_counts=True)
    assert b.memory["levels"] == dict(zip(levels.tolist(), counts.tolist()))


def test_map_reduce_validation_matches_jax(snaps):
    js, ps = snaps
    jc = JE.TPUGraphComputer(snapshot=js, num_devices=1)
    pc = PE.GPUGraphComputer(snapshot=ps, device="cpu")
    params = {"source_dense": _source(ps)}
    for comp, prog, base in ((jc, jbfs.BFS(), JMapReduce),
                             (pc, pbfs.BFS(), MapReduce)):
        with pytest.raises(ValueError, match="duplicate MapReduce"):
            comp.run(prog, params, map_reduces=[_id_list(base)(),
                                                _id_list(base)()])
        with pytest.raises(TypeError, match="not a supported MapReduce"):
            comp.run(prog, params, map_reduces=[object()])
