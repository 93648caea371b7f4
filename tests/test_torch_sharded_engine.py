"""The port's sharded engine against the JAX package's at the same mesh
size D, on the CPU: ``GPUGraphComputer(num_devices=D)`` (and
``num_devices=0`` under an initialised group of D, and ``run_sharded``
on the mesh directly) in gloo ranks (tests/torch_mesh_worker.py) against
``TPUGraphComputer(num_devices=D)`` (and JAX's ``run_sharded`` over
``vertex_mesh(D)``) at D in {1, 2, 4}. Programs: BFS, PageRank with a
``TopRanksMapReduce`` stage (tests/test_mapreduce.py's), k-core and HITS
(tests/test_models_extra.py's graphs). Integers and iteration counts are
exact; floats are held at the single-card engine tests' rtol 1e-5. HITS
at D > 1 normalises through ``parallel.mesh.global_sum``: a per-shard
sum would fail it. The checkpoint arguments refuse a mesh with JAX's
ValueError (tests/test_recovery.py)."""

import numpy as np
import pytest

import torch_mesh_worker as W
from titan_tpu.models import bfs as jbfs
from titan_tpu.models import hits as jhits
from titan_tpu.models import kcore as jkcore
from titan_tpu.models import pagerank as jpr
from titan_tpu.olap.tpu import engine as JE
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu.parallel.mesh import vertex_mesh
from titan_tpu_torch.parallel import mesh as PM
from titan_tpu_torch.parallel.multihost import launch

RTOL = 1e-5


def _random_graph(n=120, e=700, seed=4):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    keep = src != dst
    return src[keep], dst[keep], n


def _random_snap_arrays(n=64, e=400, seed=3):
    rng = np.random.default_rng(seed)
    return (n, rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32))


def _cases():
    out = []
    n, src, dst = _random_snap_arrays()
    out.append({"name": "bfs", "kind": "bfs", "n": n, "src": src,
                "dst": dst, "source": int(src[0])})
    out.append({"name": "pagerank_top_ranks", "kind": "pagerank", "n": n,
                "src": src, "dst": dst, "iterations": 15,
                "top_ranks": True})
    src, dst, n = _random_graph()
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    for k in (2, 4):
        out.append({"name": f"kcore{k}", "kind": "kcore", "n": n,
                    "src": s2, "dst": d2, "k": k})
    src, dst, n = _random_graph(seed=9)
    hs = jhits.bidirectional_snapshot(n, src, dst)
    out.append({"name": "hits", "kind": "hits", "n": n,
                "src": np.asarray(hs.src), "dst": np.asarray(hs.dst),
                "edge_values": {"fwd": np.asarray(hs.edge_values["fwd"])},
                "iterations": 12})
    return out


CASES = _cases()


def _jax_program(case):
    js = snap_mod.from_arrays(case["n"], case["src"], case["dst"],
                              edge_values=case.get("edge_values"))
    kind = case["kind"]
    if kind == "bfs":
        return jbfs.BFS(), {"source_dense": case["source"]}, js
    if kind == "kcore":
        return jkcore.KCore(case["k"]), {}, js
    if kind == "hits":
        return jhits.HITS(iterations=case["iterations"]), {}, js
    inv = np.where(js.out_degree > 0, 1.0 / np.maximum(js.out_degree, 1),
                   0.0).astype(np.float32)
    return (jpr.PageRank(iterations=case["iterations"]),
            {"n": js.n, "inv_outdeg": inv}, js)


@pytest.fixture(scope="module", params=(1, 2, 4), ids=lambda d: f"D{d}")
def runs(request, tmp_path_factory):
    D = request.param
    port = launch(W.engine_cases, D, "cpu", args=(
        [{k: v for k, v in c.items() if k != "name"} for c in CASES],
        str(tmp_path_factory.mktemp(f"ckpt{D}"))), timeout=240)
    jax = []
    for case in CASES:
        prog, params, js = _jax_program(case)
        mrs = [jpr.TopRanksMapReduce(k=5)] if case.get("top_ranks") else None
        r = JE.TPUGraphComputer(snapshot=js, num_devices=D).run(
            prog, params=params, snapshot=js, map_reduces=mrs)
        s = JE.run_sharded(prog, js, params, vertex_mesh(D))
        jax.append({"computer": (r, r.iterations, dict(r.memory)),
                    "run_sharded": (s, s.iterations, {})})
    return D, port, jax


def _same(got, want):
    (a, ia, ma), (b, ib, mb) = got, want
    assert ia == ib
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if np.issubdtype(y.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=1e-7)
        else:
            assert np.array_equal(x, y), k
    assert set(ma) == set(mb)
    for k in ma:
        assert [v for v, _ in ma[k]] == [v for v, _ in mb[k]]
        np.testing.assert_allclose([r for _, r in ma[k]],
                                   [r for _, r in mb[k]], rtol=RTOL)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_gpu_computer_equals_tpu_computer(runs, i):
    _, port, jax = runs
    _same(port["cases"][i]["computer"], jax[i]["computer"])


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_num_devices_0_takes_the_group(runs, i):
    """``num_devices=0`` under an initialised group of D runs the same as
    ``num_devices=D``."""
    _, port, jax = runs
    _same(port["cases"][i]["computer0"], jax[i]["computer"])


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_run_sharded_equals_jax(runs, i):
    """run_sharded on the mesh, at every D, 1 included (where both
    computers run the single-device engine)."""
    _, port, jax = runs
    _same(port["cases"][i]["run_sharded"], jax[i]["run_sharded"])


def test_checkpoints_need_one_device(runs):
    """JAX refuses checkpoint arguments unless num_devices is 1; the
    port refuses them with the same message."""
    D, port, _ = runs
    _, _, js = _jax_program(CASES[0])
    if D == 1:
        assert port["refusal"] is None
        return
    with pytest.raises(ValueError) as e:
        JE.TPUGraphComputer(snapshot=js, num_devices=D).run(
            jbfs.BFS(), {"source_dense": 0}, checkpoint_to="unused",
            checkpoint_every=1)
    assert port["refusal"] == str(e.value)


def test_global_sum_axis_check():
    """Outside a sharded run global_sum is a plain sum; inside a mesh
    bound with another axis name it raises, as JAX's does (no process
    group is needed to raise)."""
    import torch

    x = torch.arange(16.0)
    assert PM.bound_axes() == () and not PM.axis_bound()
    assert float(PM.global_sum(x)) == float(x.sum())
    wrong = PM.VertexMesh(0, 1, torch.device("cpu"), "gloo", axis="x")
    with PM.bound(wrong):
        assert PM.bound_axes() == ("x",) and PM.axis_bound("x")
        with pytest.raises(ValueError, match="bound mapped axes"):
            PM.global_sum(x)
    assert PM.bound_axes() == ()


def test_hits_single_device_is_unchanged():
    """HITS through global_sum on one device: bit-equal to the plain sum
    of squares it replaced."""
    import torch

    from titan_tpu_torch.models import hits as phits

    agg = torch.from_numpy(np.random.default_rng(3).random(50)
                           .astype(np.float32))
    state = {"hub": torch.ones(50), "auth": torch.ones(50),
             "phase": torch.ones(50)}
    got = phits.HITS(3).apply(state, agg, 0, {})["auth"]
    s = torch.sqrt((agg * agg).sum())
    assert torch.equal(got, agg / s)
