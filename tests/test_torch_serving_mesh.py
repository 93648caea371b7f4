"""The serving plane's ``mesh=`` in the port (a one-process
``LocalMesh``; ``parallel/partition.place_batched_csr``, the block-by-block
``frontier_bfs_batched``, ``hbm.meshed_snapshot_csr_bytes``,
``Batcher(mesh=)``, ``JobScheduler(mesh=)``) against the JAX package's
placed path, on the CPU.

JAX runs on conftest's 8 forced host devices (``vertex_mesh(D)`` takes
the first D); the port on ``local_mesh(["cpu"] * D)``, D blocks sharing
the host. The shapes are JAX's own tests': the n = 255, m = 900, seed-42
serving snapshot and R-MAT s9. Every result is bit-equal to JAX's:
``dist``, ``levels`` and ``completed`` at D in {2, 3, 8} in bfs and hops
mode, from ``init_dist``, with ``on_level`` drops, ``level_masks`` and an
explicit ``overlay=``; the per-device bytes over random snapshots; the
batcher's predicate; the scheduler's rows, ledger and config; the run
span's ``meshed``; a recovered job's checkpoint, byte for byte. The
kernels' device guard (a launch for one card while another is current)
needs several cards and is shown by ``chip_smoke.py`` and
``scripts/torch_serving_mesh_4card.py``."""

import filecmp
import os
import time
import types

import numpy as np
import pytest
import torch

import titan_tpu.models.bfs_hybrid as H
import titan_tpu.olap.api as JA
import titan_tpu.olap.recovery as JREC
import titan_tpu.olap.serving.batcher as JB
import titan_tpu.olap.serving.hbm as JH
import titan_tpu.olap.serving.scheduler as JSCH
import titan_tpu.utils.metrics as JM
import titan_tpu_torch.models.bfs_hybrid as P
import titan_tpu_torch.olap.api as PA
import titan_tpu_torch.olap.recovery as PREC
import titan_tpu_torch.olap.serving.batcher as PB
import titan_tpu_torch.olap.serving.hbm as PH
import titan_tpu_torch.olap.serving.scheduler as PSCH
import titan_tpu_torch.utils.metrics as PM
from titan_tpu.olap.live.overlay import DeltaOverlay as JaxOverlay
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu.olap.tpu.rmat import rmat_edges
from titan_tpu.parallel import partition as JP
from titan_tpu.parallel.mesh import vertex_mesh
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.live import DeltaOverlay
from titan_tpu_torch.parallel import partition as PP
from titan_tpu_torch.parallel.mesh import local_mesh

MESHES = (2, 3, 8)
WAIT = 120


def _sym(n, src, dst):
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    js = JS.from_arrays(n, np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
    return js, PS.from_numpy(js)


def _serving():
    rng = np.random.default_rng(42)
    n, m = 255, 900
    return _sym(n, rng.integers(0, n, m), rng.integers(0, n, m))


def _rmat9():
    src, dst = rmat_edges(9, 8, seed=3)
    return _sym(1 << 9, src, dst)


GRAPHS = {"serving": _serving, "rmat9": _rmat9}


@pytest.fixture(scope="module")
def graphs():
    return {k: f() for k, f in GRAPHS.items()}


def _placed(js, ps, D):
    return (JP.place_batched_csr(js, vertex_mesh(D)),
            PP.place_batched_csr(ps, local_mesh(["cpu"] * D)))


def _same(ref, got):
    d_ref, lv_ref, c_ref = ref
    d_got, lv_got, c_got = got
    assert d_got.dtype == np.int32
    assert np.array_equal(np.asarray(d_ref), d_got)
    assert np.array_equal(lv_ref, lv_got)
    assert np.array_equal(c_ref, c_got)


def _sources(snap, K, seed):
    rng = np.random.default_rng(seed)
    nz = np.flatnonzero(snap.out_degree > 0)
    return [int(s) for s in rng.choice(nz, size=K, replace=False)]


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_placed_cohort_equals_jax(graphs, name, D):
    """The K = 4 cohort of JAX's test, and its rows equal to the port's
    one-device run; each block's words reach every block."""
    js, ps = graphs[name]
    srcs = [0, 5, 9, 11] if name == "serving" else _sources(ps, 4, D)
    jp, pp = _placed(js, ps, D)
    ref = H.frontier_bfs_batched(jp, srcs)
    got = P.frontier_bfs_batched(pp, srcs, device="cpu")
    _same(ref, got)
    nb = P.plane_bytes(ps.n + 2, 4)
    # one whole array on the host, which all D blocks share
    copied = dict(P.LAST_WORDS_COPIED)
    assert copied["bytes"] and all(
        b == -(-ps.n * 4 // 8) <= nb for b in copied["bytes"])
    assert set(copied["between_devices"]) == {0}
    _same(P.frontier_bfs_batched(ps, srcs, device="cpu"), got)
    assert P.LAST_WORDS_COPIED["bytes"] == []
    assert PP.place_batched_csr(ps, local_mesh(["cpu"] * D)) is pp


def _slot_mask(js, seed):
    g = H.build_chunked_csr(js)
    lm = np.random.default_rng(seed).integers(0, 256, g["q_total"]) \
        .astype(np.uint8)
    lm[-1] = 0                            # the all-pad sink column
    return lm


def _overlays(js, ps):
    """The same adds and removals on each package's overlay of the
    serving snapshot; their views."""
    rng = np.random.default_rng(7)
    oj = JaxOverlay(js, min_cap=256)
    op = DeltaOverlay(ps, min_cap=256, device="cpu")
    a_s = rng.integers(0, js.n, 60).astype(np.int32)
    a_d = rng.integers(0, js.n, 60).astype(np.int32)
    rm = rng.choice(js.src.shape[0], 40, replace=False)
    for ov in (oj, op):
        ov.append_edges(np.concatenate([a_s, a_d]),
                        np.concatenate([a_d, a_s]),
                        np.zeros(120, np.int32))
        for i in rm:
            u, v = int(js.src[i]), int(js.dst[i])
            ov.remove_edge(u, v, None)
            ov.remove_edge(v, u, None)
    return oj.view(), op.view()


def _case(case, js, ps, srcs):
    """``(jax kwargs, port kwargs)`` of a run option."""
    if case == "hops":
        kw = dict(mode="hops", start_level=1, max_levels=4)
        return kw, kw
    if case == "init_dist":
        d, _, _ = P.frontier_bfs_batched(ps, srcs, max_levels=2,
                                         device="cpu")
        kw = dict(init_dist=d, start_level=2)
        return kw, kw
    if case == "on_level":
        def on_level(level, nf):
            # job 1 dropped at level 2, job 3 at level 3
            keep = np.ones(len(nf), bool)
            keep[1] = level < 2
            keep[3] = level < 3
            return keep
        kw = dict(on_level=on_level)
        return kw, kw
    if case == "level_masks":
        import jax.numpy as jnp

        lm = _slot_mask(js, 9)
        base = dict(mode="hops", start_level=1, max_levels=4)
        return ({**base, "level_masks": [jnp.asarray(lm), None,
                                         jnp.asarray(lm)]},
                {**base, "level_masks": [torch.from_numpy(lm), None,
                                         torch.from_numpy(lm)]})
    vj, vp = _overlays(js, ps)
    return dict(overlay=vj), dict(overlay=vp)


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("case", ["hops", "init_dist", "on_level",
                                  "level_masks", "overlay"])
def test_placed_options_equal_jax(graphs, case, D):
    js, ps = graphs["serving"]
    srcs = [0, 5, 9, 11]
    jkw, pkw = _case(case, js, ps, srcs)
    jp, pp = _placed(js, ps, D)
    got = P.frontier_bfs_batched(pp, srcs, device="cpu", **pkw)
    _same(H.frontier_bfs_batched(jp, srcs, **jkw), got)
    _same(P.frontier_bfs_batched(ps, srcs, device="cpu", **pkw), got)
    if case == "on_level":
        assert list(got[2]) == [True, False, True, False]
    if case in ("level_masks", "overlay"):    # the option bit
        plain = P.frontier_bfs_batched(
            pp, srcs, device="cpu",
            **{k: v for k, v in pkw.items()
               if k not in ("level_masks", "overlay")})
        assert not np.array_equal(plain[0], got[0])


@pytest.mark.parametrize("D", MESHES)
def test_checkpoint_gets_the_whole_dist(graphs, D):
    """``checkpoint`` gets the [K, n+1] dist gathered on the mesh's first
    device, equal to the one-device run's at every level; resuming from
    any of them finishes bit-equal."""
    _, ps = graphs["rmat9"]
    srcs = _sources(ps, 4, 1)
    caps = {}
    for key, g in (("one", ps), ("mesh", PP.place_batched_csr(
            ps, local_mesh(["cpu"] * D)))):
        caps[key] = []
        P.frontier_bfs_batched(g, srcs, device="cpu", checkpoint=lambda
                               lv, d, a, c=caps[key]: c.append(
                                   (lv, d.numpy().copy(), a.copy())))
    assert len(caps["one"]) == len(caps["mesh"]) > 2
    for (l1, d1, a1), (l2, d2, a2) in zip(caps["one"], caps["mesh"]):
        assert l1 == l2 and np.array_equal(a1, a2)
        assert d2.shape == (4, ps.n + 1) and np.array_equal(d1, d2)
    ref = P.frontier_bfs_batched(ps, srcs, device="cpu")
    pp = PP.place_batched_csr(ps, local_mesh(["cpu"] * D))
    lv, d, _ = caps["mesh"][1]
    _same(ref, P.frontier_bfs_batched(pp, srcs, device="cpu",
                                      init_dist=d[:, :ps.n], start_level=lv))


def test_empty_blocks_and_one_block(graphs):
    """A star of 30-fold edges: the hub holds half the chunk columns, so
    the 8-aligned cuts leave blocks empty; those hold nothing and the rows
    still equal the one-device run's. One block is the one-device run."""
    n = 300
    leaves = np.tile(np.arange(1, n), 30)
    js, ps = _sym(n, np.zeros_like(leaves), leaves)
    pp = PP.place_batched_csr(ps, local_mesh(["cpu"] * 8))
    assert len(pp["_shards"]) < 8
    ref = P.frontier_bfs_batched(ps, [0, 7, 100], device="cpu")
    _same(ref, P.frontier_bfs_batched(pp, [0, 7, 100], device="cpu"))
    one = PP.place_batched_csr(ps, local_mesh(["cpu"]))
    _same(ref, P.frontier_bfs_batched(one, [0, 7, 100], device="cpu"))


def test_meshed_bytes_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(40):
        n = int(rng.integers(1, 3000))
        m = int(rng.integers(0, 6 * n))
        snap = types.SimpleNamespace(
            n=n, out_degree=np.bincount(rng.integers(0, n, m),
                                        minlength=n).astype(np.int32))
        for D in (1, 2, 3, 4, 8, int(rng.integers(1, 64))):
            assert PH.meshed_snapshot_csr_bytes(snap, D) == \
                JH.meshed_snapshot_csr_bytes(snap, D)
    for D in (0, -1):                     # clamped to one device
        assert PH.meshed_snapshot_csr_bytes(snap, D) == \
            JH.meshed_snapshot_csr_bytes(snap, D)


def test_would_mesh_truth_table(graphs):
    js, ps = graphs["serving"]
    vj, vp = _overlays(js, ps)
    empty = types.SimpleNamespace(empty=True)
    for D in (1, 2, 8):
        jb = JB.Batcher(mesh=vertex_mesh(D))
        pb = PB.Batcher(mesh=local_mesh(["cpu"] * D), device="cpu")
        for kind in ("bfs", "sssp", "wcc", "pagerank", "dense",
                     "callable"):
            for ovj, ovp in ((None, None), (empty, empty), (vj, vp)):
                assert pb.would_mesh(kind, ovp) == jb.would_mesh(kind, ovj)
    assert not JB.Batcher().would_mesh("bfs", None)
    assert not PB.Batcher(device="cpu").would_mesh("bfs", None)
    assert PB._MESH_KINDS == JB._MESH_KINDS


def _run_spans(job):
    out = []

    def walk(node):
        if node["name"] == "run":
            out.append(node.get("attrs", {}))
        for c in node["children"]:
            walk(c)
    for root in job.trace.tracer.tree(job.id)["spans"]:
        walk(root)
    return out


@pytest.mark.parametrize("D", MESHES)
def test_scheduler_mesh_cohort_and_per_device_ledger(graphs, D):
    """JAX's test of the same name at D: the fused cohort runs placed,
    every row equals JAX's, the ledger charges one device's share, the
    config reports the mesh, the run span records it; a meshed SSSP
    job runs on the first device and charges the whole image."""
    js, ps = graphs["serving"]
    sources = [0, 5, 9, 11]
    out = {}
    for which in ("jax", "port"):
        if which == "jax":
            sched = JSCH.JobScheduler(snapshot=js, mesh=vertex_mesh(D),
                                      metrics=JM.MetricManager(),
                                      autostart=False)
            api = JA
        else:
            sched = PSCH.JobScheduler(snapshot=ps,
                                      mesh=local_mesh(["cpu"] * D),
                                      metrics=PM.MetricManager(),
                                      autostart=False, device="cpu")
            api = PA
        try:
            with sched._cv:
                jobs = [sched.submit(api.JobSpec(
                    kind="bfs", params={"source_dense": s}))
                    for s in sources]
            sched.start()
            for j in jobs:
                assert j.wait(WAIT), "mesh cohort did not finish"
            out[which] = (jobs, sched.ledger.resident_bytes(),
                          sched._dump_config()["mesh_devices"],
                          [_run_spans(j) for j in jobs])
        finally:
            sched.close()
    (jj, jres, jdev, jspans), (pj, pres, pdev, pspans) = \
        out["jax"], out["port"]
    assert [j.state.value for j in pj] == ["done"] * 4
    assert [j.batch_k for j in pj] == [j.batch_k for j in jj] == [4] * 4
    for a, b, s in zip(jj, pj, sources):
        assert np.array_equal(b.result["dist"], a.result["dist"])
        ref, _ = P.frontier_bfs_hybrid(ps, s, device="cpu")
        assert np.array_equal(b.result["dist"], ref)
        assert b.result["levels"] == a.result["levels"]
    assert pres == jres == PH.meshed_snapshot_csr_bytes(ps, D)
    assert pdev == jdev == D
    assert [[sp.get("meshed") for sp in s] for s in pspans] == \
        [[sp.get("meshed") for sp in s] for s in jspans] == [[D]] * 4


def test_scheduler_meshes_bfs_only(graphs):
    """SSSP on a meshed scheduler runs on its device and charges the
    whole image, as in JAX; its run span carries no ``meshed``."""
    js, ps = graphs["serving"]
    res = {}
    for which in ("jax", "port"):
        if which == "jax":
            sched = JSCH.JobScheduler(snapshot=js, mesh=vertex_mesh(2),
                                      metrics=JM.MetricManager())
            api = JA
        else:
            sched = PSCH.JobScheduler(snapshot=ps,
                                      mesh=local_mesh(["cpu"] * 2),
                                      metrics=PM.MetricManager(),
                                      device="cpu")
            api = PA
        try:
            j = sched.submit(api.JobSpec(kind="sssp",
                                         params={"source_dense": 5}))
            assert j.wait(WAIT) and j.state.value == "done"
            res[which] = (j.result["dist"], sched.ledger.resident_bytes(),
                          _run_spans(j))
        finally:
            sched.close()
    assert np.array_equal(res["port"][0].view(np.int32),
                          np.asarray(res["jax"][0]).view(np.int32))
    assert res["port"][1] == res["jax"][1] == PH.snapshot_csr_bytes(ps)
    assert all("meshed" not in sp for sp in res["port"][2])


@pytest.mark.parametrize("D", (2, 3))
def test_recovered_meshed_checkpoint_equals_jax(graphs, tmp_path, D):
    """A meshed BFS job crashed at level 2 (checkpoint every level)
    retries and resumes over the mesh in both packages; its checkpoints
    are JAX's byte for byte and the result equals JAX's."""
    js, ps = graphs["serving"]
    dirs, res = {}, {}
    for which in ("jax", "port"):
        dirs[which] = tmp_path / which
        api, rec = (JA, JREC) if which == "jax" else (PA, PREC)
        spec = api.JobSpec(kind="bfs", params={
            "source_dense": 9, "faults": rec.FaultPlan(crash_at_round=2)},
            checkpoint_every=1, max_retries=1, retry_backoff_s=0.01,
            idempotency_key="meshed-9")
        if which == "jax":
            sched = JSCH.JobScheduler(snapshot=js, mesh=vertex_mesh(D),
                                      metrics=JM.MetricManager(),
                                      checkpoint_dir=str(dirs[which]),
                                      hbm_budget_bytes=1e12)
        else:
            sched = PSCH.JobScheduler(snapshot=ps,
                                      mesh=local_mesh(["cpu"] * D),
                                      metrics=PM.MetricManager(),
                                      checkpoint_dir=str(dirs[which]),
                                      hbm_budget_bytes=1e12, device="cpu")
        try:
            j = sched.submit(spec)
            assert j.wait(WAIT)
            deadline = time.time() + 30
            while time.time() < deadline and sched._metrics.counter_value(
                    "serving.jobs.completed") < 1:
                time.sleep(0.01)
            res[which] = (j.state.value, j.attempt, j.rounds_replayed,
                          j.result["dist"],
                          sched._metrics.counter_value(
                              "serving.recovery.resumes"))
        finally:
            sched.close()
    assert res["port"][:3] == res["jax"][:3] == ("done", 2,
                                                 res["jax"][2])
    assert res["port"][4] == res["jax"][4] == 1
    assert np.array_equal(res["port"][3], res["jax"][3])
    walked = []
    for root, _, files in os.walk(dirs["jax"]):
        rel = os.path.relpath(root, dirs["jax"])
        if files:
            walked.append(rel)
            other = dirs["port"] / rel
            assert sorted(os.listdir(other)) == sorted(files), rel
            _, mismatch, errors = filecmp.cmpfiles(root, other, files,
                                                   shallow=False)
            assert mismatch == errors == [], (rel, mismatch, errors)
    assert any("ckpt-" in w for w in walked)
