"""The port's Graph500 pipeline (titan_tpu_torch.olap.graph500, its native
library and its R-MAT copy) against the JAX package's, on the CPU, and
the state transfer that runs both packages on the very same graph."""

import os

import numpy as np
import pytest
import torch

import titan_tpu.models.bfs_hybrid as H
from titan_tpu import native as jax_native
from titan_tpu.olap.tpu import graph500 as J
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu.olap.tpu.rmat import rmat_edges as jax_rmat_edges
from titan_tpu_torch import build
from titan_tpu_torch.device import INF
from titan_tpu_torch.models.bfs_hybrid import frontier_bfs_hybrid
from titan_tpu_torch.olap import graph500 as P
from titan_tpu_torch.olap.rmat import rmat_edges

ARRAYS = ("dstT", "colstart", "deg", "deg_orig")
META = ("n", "q_total", "m_input", "e_dedup", "e_sym")


@pytest.mark.parametrize("generator", ["native", "numpy"])
def test_load_or_build_matches_jax(generator, tmp_path, monkeypatch):
    if generator == "numpy":
        # the JAX package picks numpy only when its native module is absent
        monkeypatch.setattr(jax_native, "available", False)
    elif not jax_native.available:
        pytest.fail("the JAX package's native module did not build")
    ref = J.load_or_build(10, 16, seed=2, cache_dir=str(tmp_path / "jax"),
                          verbose=False)
    got = P.load_or_build(10, 16, seed=2, cache_dir=str(tmp_path / "port"),
                          verbose=False, generator=generator)
    assert ref["generator"] == got["generator"] == generator
    for k in ARRAYS:
        assert got[k].dtype == ref[k].dtype, k
        assert np.array_equal(got[k], ref[k]), k
    for k in META:
        assert got[k] == ref[k], k
    # the second call reads the cache back
    again = P.load_or_build(10, 16, seed=2, cache_dir=str(tmp_path / "port"),
                            verbose=False, generator=generator)
    assert all(np.array_equal(again[k], got[k]) for k in ARRAYS)


def test_generator_choice_is_checked():
    with pytest.raises(ValueError, match="generator"):
        P.load_or_build(4, generator="fast")


def test_rmat_copy_matches_jax():
    for a, b in zip(rmat_edges(9, 8, seed=5), jax_rmat_edges(9, 8, seed=5)):
        assert np.array_equal(a, b)


def test_failed_native_build_raises(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        build.build_shared(str(src), ["g++", "-shared", "-fPIC"],
                           str(tmp_path / "out"), "broken")
    assert not os.listdir(tmp_path / "out")


def _snap(seed=4, n=200, m=1000):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    return snap_mod.from_arrays(n, np.concatenate([src, dst]),
                                np.concatenate([dst, src]))


def test_graph_from_numpy_on_jax_host_arrays():
    """The JAX package's chunked CSR, carried over as numpy arrays, gives
    the port the same device arrays and the same BFS."""
    snap = _snap()
    jg = H.build_chunked_csr(snap)
    g = P.graph_from_numpy(jg["_host"], device="cpu")
    assert g["n"] == jg["n"] and g["q_total"] == jg["q_total"]
    for k in ("dstT", "colstart", "degc"):
        assert g[k].dtype == torch.int32
        assert np.array_equal(g[k].numpy(), np.asarray(jg[k])), k
    src = int(np.flatnonzero(snap.out_degree > 0)[0])
    d_ref, lv_ref = H.frontier_bfs_hybrid(snap, src)
    d_got, lv_got = frontier_bfs_hybrid(g, src, device="cpu")
    assert np.array_equal(np.asarray(d_ref), d_got) and lv_got == lv_ref


def test_reachable_edge_sum_matches_jax(tmp_path):
    hg = J.load_or_build(9, 16, seed=3, cache_dir=str(tmp_path),
                         verbose=False)
    src = int(np.flatnonzero(np.asarray(hg["deg"]) > 0)[0])
    d_ref, _ = H.frontier_bfs_hybrid(J.to_device(hg), src,
                                     return_device=True)
    ref = J.reachable_edge_sum(d_ref, np.asarray(hg["deg_orig"]), INF)
    g = P.graph_from_numpy(hg, device="cpu")
    d_got, _ = frontier_bfs_hybrid(g, src, return_device=True, device="cpu")
    deg_orig = np.asarray(hg["deg_orig"])
    got = P.reachable_edge_sum(d_got, deg_orig, INF)
    assert got == ref
    assert got == P.reachable_edge_sum(
        d_got, deg_orig, INF, deg_dev=P.device_degrees(deg_orig, "cpu"))
    assert 0 < got[1] <= hg["n"]


def test_upload_requires_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.graph_from_numpy(H.build_chunked_csr(_snap())["_host"])
