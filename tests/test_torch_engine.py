"""The port's vertex-program engine (titan_tpu_torch.olap.engine and the
six DenseProgram models) on the CPU, against the JAX package's
single-device engine (``run_single`` through ``TPUGraphComputer(...,
num_devices=1)``; on the CPU its combine is the ``jax.ops.segment_*``
scatter). The JAX snapshot goes through ``from_numpy``, so both engines
see the same arrays.

BFS, WCC, SSSP and k-core are exact, iteration counts included (min
combines, and k-core's sums of 0/1 are exact in float32). PageRank and
HITS sum float32 messages in scan order here and in scatter order in
JAX, so they are held at rtol 1e-5 (about 100 float32 ulps; the
observed gap is under 1e-6)."""

import functools

import numpy as np
import pytest
import torch

import titan_tpu.models.bfs as jbfs
import titan_tpu.models.hits as jhits
import titan_tpu.models.kcore as jkcore
import titan_tpu.models.pagerank as jpr
import titan_tpu.models.sssp as jsssp
import titan_tpu.models.wcc as jwcc
import titan_tpu_torch.models.bfs as pbfs
import titan_tpu_torch.models.hits as phits
import titan_tpu_torch.models.kcore as pkcore
import titan_tpu_torch.models.pagerank as ppr
import titan_tpu_torch.models.sssp as psssp
import titan_tpu_torch.models.wcc as pwcc
from titan_tpu.olap.tpu import engine as JE
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu.olap.tpu.rmat import rmat_edges
from titan_tpu_torch.ops import segment as SG
from titan_tpu_torch.olap import engine as PE
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.api import DenseMapReduce, DenseProgram
from titan_tpu_torch.parallel.mesh import vertex_mesh

GRAPHS = ["random"] + [f"rmat{s}" for s in range(8, 13)]
RTOL = 1e-5


@functools.cache
def _edges(name):
    """Directed edge list: the repo-shared n=192/m=900/seed-42 shape
    (symmetrized, as the other tests build it), or R-MAT at a scale."""
    if name == "random":
        rng = np.random.default_rng(42)
        s, d = rng.integers(0, 192, 900), rng.integers(0, 192, 900)
        return 192, np.concatenate([s, d]), np.concatenate([d, s])
    scale = int(name[4:])
    src, dst = rmat_edges(scale, 16, seed=scale)
    return 1 << scale, np.asarray(src), np.asarray(dst)


@functools.cache
def _pair(name, kind):
    """(JAX computer and snapshot, port computer and snapshot) over one
    graph: ``directed`` with float32 weights, ``sym`` symmetrized, or
    ``hits`` (forward + backward edges with the fwd flag)."""
    n, src, dst = _edges(name)
    if kind == "hits":
        js = jhits.bidirectional_snapshot(n, src, dst)
    else:
        if kind == "sym":
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.random.default_rng(1).uniform(0.1, 10.0, len(src))
        js = JS.from_arrays(n, src, dst,
                            edge_values={"weight": w.astype(np.float32)})
    ps = PS.from_numpy(js)
    return (JE.TPUGraphComputer(snapshot=js, num_devices=1), js,
            PE.GPUGraphComputer(snapshot=ps, device="cpu"), ps)


def _source(snap):
    """bench.py's rule: default_rng(12345) over vertices with out-edges."""
    nz = np.flatnonzero(snap.out_degree > 0)
    return int(np.random.default_rng(12345).choice(nz))


def _exact(a, b, key):
    assert a.iterations == b.iterations
    assert a[key].dtype == b[key].dtype
    np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("name", GRAPHS)
def test_pagerank(name):
    jc, js, pc, ps = _pair(name, "directed")
    a, b = jpr.run(jc, snapshot=js), ppr.run(pc, snapshot=ps)
    assert a.iterations == b.iterations == 20
    np.testing.assert_allclose(b["rank"], a["rank"], rtol=RTOL)


@pytest.mark.parametrize("name", GRAPHS)
def test_bfs(name):
    jc, js, pc, ps = _pair(name, "directed")
    src = _source(ps)
    _exact(jbfs.run(jc, src, snapshot=js), pbfs.run(pc, src, snapshot=ps),
           "dist")


@pytest.mark.parametrize("name", GRAPHS)
def test_sssp_and_max_distance(name):
    jc, js, pc, ps = _pair(name, "directed")
    src = _source(ps)
    a = jc.run(jsssp.SSSP(), {"source_dense": src}, js,
               [jsssp.MaxDistanceMapReduce()])
    b = pc.run(psssp.SSSP(), {"source_dense": src}, ps,
               [psssp.MaxDistanceMapReduce()])
    _exact(a, b, "dist")
    assert a.memory == b.memory
    _exact(a, psssp.run(pc, src, snapshot=ps), "dist")


@pytest.mark.parametrize("name", GRAPHS)
def test_wcc(name):
    jc, js, pc, ps = _pair(name, "sym")
    _exact(jwcc.run(jc, snapshot=js), pwcc.run(pc, snapshot=ps), "label")


@pytest.mark.parametrize("name,k", [(g, 4) for g in GRAPHS]
                         + [("rmat10", 2), ("rmat10", 16)])
def test_kcore(name, k):
    jc, js, pc, ps = _pair(name, "sym")
    a, b = jkcore.run(jc, k, snapshot=js), pkcore.run(pc, k, snapshot=ps)
    _exact(a, b, "in_core")


@pytest.mark.parametrize("name", GRAPHS)
def test_hits(name):
    jc, js, pc, ps = _pair(name, "hits")
    a, b = jhits.run(jc, snapshot=js), phits.run(pc, snapshot=ps)
    assert a.iterations == b.iterations == 40
    for key in ("hub", "auth"):
        np.testing.assert_allclose(b[key], a[key], rtol=RTOL, atol=1e-7)


def test_bidirectional_snapshot_matches_jax():
    n, src, dst = _edges("rmat9")
    a = jhits.bidirectional_snapshot(n, src, dst)
    b = phits.bidirectional_snapshot(n, src, dst)
    for f in ("src", "dst", "indptr_in", "out_degree", "vertex_ids"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.edge_values["fwd"], b.edge_values["fwd"])


@pytest.mark.parametrize("k", [1, 10, 5000])
@pytest.mark.parametrize("ties", [False, True])
def test_top_ranks_orders_like_jax(k, ties):
    """Highest first, and the lower index first among equal ranks."""
    _, js, _, ps = _pair("rmat12", "directed")
    rank = np.random.default_rng(3).random(js.n).astype(np.float32)
    if ties:
        rank = np.round(rank * 8) / 8
    a = jpr.TopRanksMapReduce(k).compute({"rank": rank}, js, {})
    b = ppr.TopRanksMapReduce(k).compute({"rank": rank}, ps, {})
    assert a == b


@pytest.mark.parametrize("name", ["random", "rmat10"])
def test_top_ranks_through_the_computer(name):
    jc, js, pc, ps = _pair(name, "directed")
    a = jpr.run(jc, snapshot=js)
    jc.run(jpr.PageRank(), {"n": js.n, "inv_outdeg": _inv(js)}, js,
           [jpr.TopRanksMapReduce(8)])
    b = pc.run(ppr.PageRank(), {"n": ps.n, "inv_outdeg": _inv(ps)}, ps,
               [ppr.TopRanksMapReduce(8)])
    top = b.memory["pageRank"]
    assert [v for v, _ in top] == [v for v, _ in jpr.TopRanksMapReduce(
        8).compute(dict(a), js, {})]
    np.testing.assert_allclose([r for _, r in top],
                               np.sort(a["rank"])[::-1][:8], rtol=RTOL)


def _inv(snap):
    outdeg = np.maximum(snap.out_degree, 1).astype(np.float32)
    return np.where(snap.out_degree > 0, 1.0 / outdeg, 0.0).astype(
        np.float32)


@pytest.mark.parametrize("max_iterations", [0, 1, 2])
def test_iteration_budget(max_iterations):
    jc, js, pc, ps = _pair("rmat9", "directed")
    src = _source(ps)
    _exact(jbfs.run(jc, src, snapshot=js, max_iterations=max_iterations),
           pbfs.run(pc, src, snapshot=ps, max_iterations=max_iterations),
           "dist")


def test_pagerank_tol_stops_early_like_jax():
    jc, js, pc, ps = _pair("rmat10", "directed")
    a = jpr.run(jc, iterations=200, tol=1e-6, snapshot=js)
    b = ppr.run(pc, iterations=200, tol=1e-6, snapshot=ps)
    assert 1 < a.iterations < 200
    assert abs(a.iterations - b.iterations) <= 1    # float32 sums differ
    np.testing.assert_allclose(b["rank"], a["rank"], rtol=1e-4)


def test_device_graph_is_uploaded_once():
    _, _, pc, ps = _pair("random", "directed")
    g = PE.device_graph(ps, "cpu")
    assert PE.device_graph(ps, "cpu") is g
    assert torch.equal(g.flags, SG.segment_flags(g.dst))
    li, sh = SG.segment_metadata(ps.indptr_in)
    np.testing.assert_array_equal(g.last_idx.numpy(), li)
    np.testing.assert_array_equal(g.seg_has.numpy(), sh)


class _Noop(DenseProgram):
    def init(self, n, params):
        return {"x": torch.zeros(n)}

    def message(self, src_state, edge_data, params):
        return src_state["x"]

    def apply(self, state, agg, iteration, params):
        return {"x": agg}


def test_computer_raises_for_what_is_not_ported(monkeypatch):
    _, _, pc, ps = _pair("random", "directed")
    prog = _Noop()
    # the scheduler and its interactive lane are ported: the lane runs on
    # the computer's device
    sched = pc.scheduler(autostart=False, hbm_budget_bytes=1e12)
    try:
        lane = sched.interactive()
        assert lane is sched.interactive() and lane.device == pc.device
    finally:
        sched.close()
    assert lane.closed
    # the multi-device engine is ported: it needs an initialised process
    # group (none here) for its mesh
    with pytest.raises(RuntimeError, match="process group"):
        PE.run_sharded(prog, ps, None, vertex_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="fixed snapshot"):
        pc.snapshot(directed=False)
    assert pc.snapshot() is ps
    result = pc.run(prog, map_reduces=[])
    assert (result.iterations, result.n, result.memory) == (50, ps.n, {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PE.GPUGraphComputer(snapshot=ps)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PE.run_single(prog, ps)


def test_dense_map_reduce_is_abstract():
    with pytest.raises(TypeError):
        DenseMapReduce()
