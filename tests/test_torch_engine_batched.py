"""The port's batched engine (``olap/engine.run_single_batched`` through
``GPUGraphComputer.run_batched``) on the CPU, against the JAX package's
``titan_tpu.olap.tpu.engine.run_single_batched`` on the same snapshot,
and the K-row form of the plain scan and of the sorted combine.

Graphs: the repo-shared n=192/m=900/seed-42 shape (symmetrized) and
R-MAT s10. BFS, SSSP, WCC and k-core are exact against JAX, iteration
counts included; PageRank and HITS sum float32 messages in scan order
here and in scatter order in JAX, so they are held at rtol 1e-5, the
tolerance of ``test_torch_engine.py``. Every job is also held bit-equal,
iterations included, to the port's own ``run_single`` with its params:
each job runs exactly the expressions of the single run on its row.
"""

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
from titan_tpu_torch.olap import engine as PE
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.ops import seg_scan as S
from titan_tpu_torch.ops import segment as SG

GRAPHS = ["random", "rmat10"]
RTOL = 1e-5


@functools.cache
def _pair(name, kind):
    """(JAX snapshot, port computer, port snapshot) over one graph:
    ``directed`` with float32 weights, ``sym`` symmetrized, or ``hits``
    (forward + backward edges with the fwd flag)."""
    if name == "random":
        rng = np.random.default_rng(42)
        s, d = rng.integers(0, 192, 900), rng.integers(0, 192, 900)
        n, src, dst = 192, np.concatenate([s, d]), np.concatenate([d, s])
    else:
        src, dst = rmat_edges(10, 16, seed=10)
        n, src, dst = 1 << 10, np.asarray(src), np.asarray(dst)
    if kind == "hits":
        js = jhits.bidirectional_snapshot(n, src, dst)
    else:
        if kind == "sym":
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.random.default_rng(1).uniform(0.1, 10.0, len(src))
        js = JS.from_arrays(n, src, dst,
                            edge_values={"weight": w.astype(np.float32)})
    ps = PS.from_numpy(js)
    return js, PE.GPUGraphComputer(snapshot=ps, device="cpu"), ps


def _sources(snap, k):
    """k distinct sources by bench.py's rule (default_rng(12345) over
    vertices with out-edges), the last one a vertex with no in-edges where
    there is one, so its job freezes after its first superstep."""
    nz = np.flatnonzero(snap.out_degree > 0)
    out = [int(s) for s in np.random.default_rng(12345).choice(
        nz, size=k, replace=False)]
    lonely = np.flatnonzero(np.diff(snap.indptr_in) == 0)
    if len(lonely):
        out[-1] = int(lonely[0])
    return out


def _inv(snap):
    outdeg = np.maximum(snap.out_degree, 1).astype(np.float32)
    return np.where(snap.out_degree > 0, 1.0 / outdeg, 0.0).astype(
        np.float32)


def _check(jres, pres, singles, keys, exact):
    assert len(jres) == len(pres) == len(singles)
    for a, b, c in zip(jres, pres, singles):
        assert a.iterations == b.iterations == c.iterations
        for key in keys:
            assert b[key].dtype == a[key].dtype
            np.testing.assert_array_equal(b[key], c[key])
            if exact:
                np.testing.assert_array_equal(b[key], a[key])
            else:
                np.testing.assert_allclose(b[key], a[key], rtol=RTOL,
                                           atol=1e-7)


def _run(jprog, pprog, params_list, name, kind, keys, exact):
    js, pc, ps = _pair(name, kind)
    jres = JE.run_single_batched(jprog, js, params_list)
    pres = pc.run_batched(pprog, params_list, snapshot=ps)
    singles = [PE.run_single(pprog, ps, p, device="cpu")
               for p in params_list]
    _check(jres, pres, singles, keys, exact)
    return pres


@pytest.mark.parametrize("name", GRAPHS)
def test_bfs_k8(name):
    js, _, _ = _pair(name, "directed")
    params = [{"source_dense": s} for s in _sources(js, 8)]
    res = _run(jbfs.BFS(), pbfs.BFS(), params, name, "directed", ["dist"],
               True)
    if (np.diff(js.indptr_in) == 0).any():    # a lonely source: R-MAT
        assert res[-1].iterations == 1 < res[0].iterations


@pytest.mark.parametrize("name", GRAPHS)
def test_sssp_weighted_k4(name):
    js, _, _ = _pair(name, "directed")
    params = [{"source_dense": s} for s in _sources(js, 4)]
    _run(jsssp.SSSP(), psssp.SSSP(), params, name, "directed", ["dist"],
         True)


@pytest.mark.parametrize("name", GRAPHS)
def test_wcc_k2(name):
    _run(jwcc.WCC(), pwcc.WCC(), [{}, {}], name, "sym", ["label"], True)


@pytest.mark.parametrize("name", GRAPHS)
def test_kcore_k2(name):
    _run(jkcore.KCore(4), pkcore.KCore(4), [{}, {}], name, "sym",
         ["in_core"], True)


@pytest.mark.parametrize("name", GRAPHS)
def test_pagerank_k3(name):
    js, _, _ = _pair(name, "directed")
    params = [{"n": js.n, "inv_outdeg": _inv(js)}] * 3
    _run(jpr.PageRank(), ppr.PageRank(), params, name, "directed", ["rank"],
         False)


@pytest.mark.parametrize("name", GRAPHS)
def test_hits_k3(name):
    _run(jhits.HITS(), phits.HITS(), [{}] * 3, name, "hits",
         ["hub", "auth"], False)


@pytest.mark.parametrize("max_iterations", [0, 1, 2])
def test_iteration_budget(max_iterations):
    js, _, _ = _pair("rmat10", "directed")
    params = [{"source_dense": s} for s in _sources(js, 3)]
    res = _run(jbfs.BFS(max_iterations), pbfs.BFS(max_iterations), params,
               "rmat10", "directed", ["dist"], True)
    # the lonely source's job converges after one superstep
    assert [r.iterations for r in res] == \
        [max_iterations] * 2 + [min(max_iterations, 1)]


@pytest.mark.parametrize("params_list,exc,match", [
    ([], ValueError, "needs >= 1 params set"),
    ([{"source_dense": 1}, {"source": 1}], ValueError, "share a params key"),
    ([{"source_dense": "3"}], TypeError, "must be numeric; 'source_dense' "
                                         "is str"),
])
def test_validation_errors_match_jax(params_list, exc, match):
    js, pc, _ = _pair("random", "directed")
    with pytest.raises(exc, match=match):
        JE.run_single_batched(jbfs.BFS(), js, params_list)
    with pytest.raises(exc, match=match):
        pc.run_batched(pbfs.BFS(), params_list)


def test_apply_may_return_rows_of_other_keys():
    """An ``apply`` that swaps two state keys (each new array a row of the
    other key) gives each job what ``run_single`` gives it."""
    from titan_tpu_torch.olap.api import DenseProgram

    class Swap(DenseProgram):
        max_iterations = 3

        def init(self, n, params):
            return {"a": torch.full((n,), float(params["x"])),
                    "b": torch.arange(n, dtype=torch.float32)}

        def message(self, src_state, edge_data, params):
            return src_state["a"]

        def apply(self, state, agg, iteration, params):
            # "b" first: written before "a" reads the old "b"
            return {"b": state["a"] + agg, "a": state["b"]}

    _, pc, ps = _pair("random", "directed")
    params = [{"x": 1.0}, {"x": 2.5}]
    for got, p in zip(pc.run_batched(Swap(), params), params):
        want = PE.run_single(Swap(), ps, p, device="cpu")
        for key in ("a", "b"):
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("combine", S.COMBINES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_row_scan_reference_equals_one_row_scans(dtype, combine, k, pad):
    """The plain K-row scan of [K, E + pad] is bit-equal, row by row, to
    the one-row scan of that row's first E values."""
    rng = np.random.default_rng(7)
    e = 1000
    if dtype == torch.float32:
        vals = torch.from_numpy(rng.uniform(-1, 1, (k, e + pad))
                                .astype(np.float32))
    else:
        vals = torch.from_numpy(rng.integers(-2**31, 2**31, (k, e + pad),
                                             dtype=np.int64)
                                .astype(np.int32))
    flags = torch.from_numpy(rng.random(e) < 0.05)
    got = S.seg_scan(vals, flags, combine)
    assert tuple(got.shape) == (k, e)
    for r in range(k):
        want = S.seg_scan_reference(vals[r, :e].contiguous(), flags, combine)
        assert torch.equal(got[r], want)


@pytest.mark.parametrize("combine", S.COMBINES)
def test_row_combine_equals_one_row_combines(combine):
    """The K-row sorted combine into a strided [K, n] view equals the
    one-row combine of each row; rows of an edgeless graph get the
    identity."""
    _, _, ps = _pair("rmat10", "directed")
    g = PE.device_graph(ps, "cpu")
    e, n = g.src.shape[0], ps.n
    vals = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (3, e + 2)).astype(np.float32))
    out = torch.full((3, n + 3), 7.0)[:, :n]
    got = SG.sorted_segment_combine(vals, g.dst, g.last_idx, g.seg_has,
                                    combine, flags=g.flags, out=out)
    assert got.data_ptr() == out.data_ptr()
    for r in range(3):
        want = SG.segment_combine(vals[r, :e].contiguous(), g.dst, n,
                                  combine, last_idx=g.last_idx,
                                  seg_has=g.seg_has, flags=g.flags)
        assert torch.equal(got[r], want)
    empty = torch.zeros((0,), dtype=torch.int32)
    none = SG.sorted_segment_combine(torch.zeros((2, 4)), empty,
                                     torch.full((5,), -1, dtype=torch.int32),
                                     torch.zeros(5, dtype=torch.bool),
                                     combine)
    assert torch.equal(none, torch.full((2, 5), SG.combine_identity(
        combine, torch.float32)))
