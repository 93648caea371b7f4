"""The port's sharded hybrid BFS (titan_tpu_torch.models.
bfs_hybrid_sharded.frontier_bfs_hybrid_sharded) against the JAX package's
at the same mesh size D, on the CPU: the port's ranks are gloo processes
(``parallel/multihost.launch``, tests/torch_mesh_worker.py), JAX's mesh
is ``vertex_mesh(D)`` over conftest's virtual devices. ``dist``,
``levels``, ``LAST_EXCHANGE_CAPS`` and ``LAST_PROFILE`` are equal at D in
{1, 2, 4}, and ``dist`` and ``levels`` equal the port's single-card
hybrid. The cases are those of tests/test_sharded_bfs.py and
tests/test_sharded_exchange.py: R-MAT graphs (whose second level
overflows the first exchange cap: a retry), a random graph and the path
graphs whose one-vertex frontiers keep the exchange sparse."""

import functools

import numpy as np
import pytest

import torch_mesh_worker as W
from titan_tpu.models import bfs_hybrid_sharded as JS
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu.olap.tpu.rmat import rmat_edges
from titan_tpu.parallel.mesh import vertex_mesh
from titan_tpu_torch.models.bfs_hybrid import frontier_bfs_hybrid
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.parallel.multihost import launch

WORLDS = (1, 2, 4)


def _sym(name, src, dst, n):
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    snap = snap_mod.from_arrays(n, s2, d2)
    return {"name": name, "n": n, "src": s2, "dst": d2,
            "source": int(np.flatnonzero(snap.out_degree > 0)[0]),
            "snap": snap}


def _cases():
    out = []
    for scale, seed in ((9, 3), (8, 5)):
        src, dst = rmat_edges(scale, 8, seed=seed)
        out.append(_sym(f"rmat{scale}", src, dst, 1 << scale))
    rng = np.random.default_rng(9)
    n = int(rng.integers(64, 500))
    m = int(rng.integers(n, 4 * n))
    out.append(_sym("random", rng.integers(0, n, m), rng.integers(0, n, m),
                    n))
    for n in (96, 400):
        path = np.arange(n - 1, dtype=np.int32)
        out.append(_sym(f"path{n}", path, path + 1, n))
    return out


CASES = _cases()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda d: f"D{d}")
def runs(request):
    """One launch a world size, every case in it; and JAX's runs at the
    same D."""
    D = request.param
    port = launch(W.sharded_bfs_cases, D, "cpu", args=(
        [{k: c[k] for k in ("n", "src", "dst", "source")} for c in CASES],),
        timeout=240)
    jax = []
    for c in CASES:
        dist, levels = JS.frontier_bfs_hybrid_sharded(c["snap"], c["source"],
                                                      vertex_mesh(D))
        jax.append({"dist": np.asarray(dist), "levels": levels,
                    "caps": list(JS.LAST_EXCHANGE_CAPS),
                    "profile": [dict(p) for p in JS.LAST_PROFILE]})
    return D, port, jax


@functools.cache
def _single_card(i):
    case = CASES[i]
    ps = PS.from_arrays(case["n"], case["src"], case["dst"])
    return frontier_bfs_hybrid(ps, case["source"], device="cpu")


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_dist_and_levels_equal_jax_and_the_single_card_hybrid(runs, i):
    _, port, jax = runs
    assert np.array_equal(port[i]["dist"], jax[i]["dist"])
    assert port[i]["levels"] == jax[i]["levels"]
    ref, levels = _single_card(i)
    assert np.array_equal(port[i]["dist"], ref)
    assert port[i]["levels"] == levels


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_exchange_caps_and_profile_equal_jax(runs, i):
    """Field for field: mode, nf, m8_f, found_max_per_chip, found_cap,
    exchanged_ids, retries, dispatches and the bottom-up trail."""
    _, port, jax = runs
    assert port[i]["caps"] == jax[i]["caps"]
    assert port[i]["profile"] == jax[i]["profile"]


def test_paths_keep_the_exchange_sparse_and_retry(runs):
    """A path's frontier is one vertex a level: every exchange cap stays
    tiny and the level count is n - 1 or n. R-MAT's second level retries
    with the exact cap, since the source's degree underestimates it."""
    D, port, _ = runs
    for i, case in enumerate(CASES):
        if not case["name"].startswith("path"):
            continue
        n = case["n"]
        assert max(port[i]["caps"]) <= 8 < n
        assert port[i]["levels"] in (n - 1, n)
        assert all(p["dispatches"] == 1 + p["retries"]
                   for p in port[i]["profile"])
        assert all(p["exchanged_ids"] == D * p["found_cap"]
                   for p in port[i]["profile"])
    rm = port[0]["profile"]
    assert any(p["retries"] > 0 for p in rm), rm
