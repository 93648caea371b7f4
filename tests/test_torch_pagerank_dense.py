"""The port's dense-window PageRank (titan_tpu_torch.models.frontier
.pagerank_dense) and batched personalized PageRank with its per-user top-k
(titan_tpu_torch.models.pagerank) against the JAX package's, on the CPU.

Tolerances. PageRank sums float32 contributions, and a sum in another
order rounds differently; on the CPU, though, both packages add in the
same order (the window's scatter-add lane by lane over the columns, as
XLA's CPU scatter walks its [8, W] updates) and the port rounds the
finish as XLA's fused multiply-add does, so the ranks are held BIT-EQUAL
to JAX here. Against a float64 PageRank the float32 run is held to
``_f64_rtol``: each float32 sum of k positive terms errs by at most
(k-1)·2^-24 of the sum, the finish adds two roundings, and the error
contracts by the damping d each iteration, so the relative error stays
below (k_max + 2)·2^-24 / (1 - d). The personalized batch runs each row
through exactly the operations of ``pagerank_dense(reset=row)``, so rows
are bit-equal to those runs (and to JAX's batch)."""

import numpy as np
import pytest
import torch

import titan_tpu.models.frontier as JF
import titan_tpu.models.pagerank as JP
import titan_tpu_torch.models.frontier as PF
import titan_tpu_torch.models.pagerank as PP
from titan_tpu.olap.live.overlay import DeltaOverlay as JaxOverlay
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu.olap.tpu.rmat import rmat_edges
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.live import DeltaOverlay


def _sym(n, src, dst):
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    return JS.from_arrays(n, np.concatenate([src, dst]),
                          np.concatenate([dst, src]))


def _random(seed, m=900):
    rng = np.random.default_rng(seed)
    return _sym(192, rng.integers(0, 192, m), rng.integers(0, 192, m))


def _rmat(scale):
    src, dst = rmat_edges(scale, 16, seed=scale)
    return _sym(1 << scale, src, dst)


def _path(n=50):
    es = np.arange(n - 1)
    return _sym(n, es, es + 1)


def _hubs():
    src = [0] * 81 + [200] * 101 + [201] * 60 + [300]
    dst = (list(range(1, 81)) + [300] + list(range(100, 200)) + [300]
           + list(range(202, 261)) + [300] + [301])
    return _sym(302, src, dst)


GRAPHS = {"random42": lambda: _random(42), "sparse": lambda: _random(1, 150),
          "rmat8": lambda: _rmat(8), "rmat11": lambda: _rmat(11),
          "path": _path, "hubs": _hubs}


def _exact(ref, got):
    ref = np.asarray(ref)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == ref.shape
    assert np.array_equal(ref.view(np.int32), got.view(np.int32))


def _f64_pagerank(snap, iterations, damping=0.85, reset=None):
    """Float64 push PageRank over the snapshot's edges."""
    n = snap.n
    deg = np.bincount(snap.src, minlength=n).astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    tele = (1 - damping) / n if reset is None \
        else (1 - damping) * np.asarray(reset, np.float64)
    rank = np.full(n, 1.0 / n) if reset is None \
        else np.asarray(reset, np.float64)
    for _ in range(iterations):
        acc = np.zeros(n)
        np.add.at(acc, snap.dst, (rank * inv)[snap.src])
        rank = tele + damping * acc
    return rank


def _f64_rtol(snap, damping=0.85):
    k_max = int(np.bincount(snap.dst, minlength=snap.n).max())
    return (k_max + 2) * 2.0**-24 / (1 - damping)


def _one_hot(n, s):
    r = np.zeros(n, np.float32)
    r[s] = 1.0
    return r


@pytest.mark.parametrize("name", list(GRAPHS))
def test_uniform_bit_equal_to_jax_and_near_float64(name):
    snap = GRAPHS[name]()
    ref, it_ref = JF.pagerank_dense(snap, iterations=15)
    got, it = PF.pagerank_dense(snap, iterations=15, device="cpu")
    assert it == it_ref == 15
    _exact(ref, got)
    f64 = _f64_pagerank(snap, 15)
    assert np.max(np.abs(got - f64) / f64) <= _f64_rtol(snap)


@pytest.mark.parametrize("kind", ["one_hot", "spread"])
@pytest.mark.parametrize("name", ["random42", "rmat11", "hubs"])
def test_reset_bit_equal_to_jax_and_near_float64(name, kind):
    snap = GRAPHS[name]()
    rng = np.random.default_rng(4)
    if kind == "one_hot":
        reset = _one_hot(snap.n, int(np.flatnonzero(snap.out_degree)[0]))
    else:
        reset = rng.random(snap.n).astype(np.float32)
        reset /= reset.sum()
    ref, _ = JF.pagerank_dense(snap, iterations=12, reset=reset)
    got, _ = PF.pagerank_dense(snap, iterations=12, reset=reset,
                               device="cpu")
    _exact(ref, got)
    f64 = _f64_pagerank(snap, 12, reset=reset)
    live = f64 > 0
    assert (got[~live] == 0).all()
    assert np.max(np.abs(got[live] - f64[live]) / f64[live]) \
        <= _f64_rtol(snap)


@pytest.mark.parametrize("tol", [1e-5, 1e-7])
@pytest.mark.parametrize("name", ["random42", "rmat8"])
def test_tol_stops_at_the_same_iteration_as_jax(name, tol):
    snap = GRAPHS[name]()
    ref, it_ref = JF.pagerank_dense(snap, iterations=500, tol=tol)
    got, it = PF.pagerank_dense(snap, iterations=500, tol=tol,
                                device="cpu")
    assert it == it_ref < 500
    _exact(ref, got)


@pytest.mark.parametrize("W", [3, 7, 13, 64])
def test_windows_bit_equal_to_jax(W, monkeypatch):
    """Windows that do not divide the column count: JAX clamps the last
    window's start and masks the overlap; the port's last window is just
    shorter. Both equal the one-window run to float32 order error and
    each other bit for bit."""
    snap = _random(15, 600)
    whole, _ = PF.pagerank_dense(snap, iterations=8, device="cpu")
    for mod in (JF, PF):
        monkeypatch.setattr(mod, "DENSE_WINDOW", W)
    ref, _ = JF.pagerank_dense(snap, iterations=8)
    got, _ = PF.pagerank_dense(snap, iterations=8, device="cpu")
    _exact(ref, got)
    assert np.max(np.abs(got - whole) / whole) <= _f64_rtol(snap)


def test_checkpoint_resume_and_veto_match_jax():
    snap = _rmat(8)
    caps = {"jax": {}, "port": {}}

    def keep(who):
        def cb(it, state):
            caps[who][it] = np.asarray(state["rank"]).copy()
        return cb
    ref, _ = JF.pagerank_dense(snap, iterations=10, checkpoint=keep("jax"))
    got, _ = PF.pagerank_dense(snap, iterations=10,
                               checkpoint=keep("port"), device="cpu")
    _exact(ref, got)
    assert sorted(caps["jax"]) == sorted(caps["port"]) == list(range(1, 11))
    for it in caps["jax"]:
        assert caps["port"][it].shape == (snap.n + 1,)
        _exact(caps["jax"][it], caps["port"][it])
    for state in (caps["port"][4], caps["jax"][4]):
        again, it = PF.pagerank_dense(snap, iterations=10, device="cpu",
                                      resume={"rank": state, "it": 4})
        assert it == 10
        _exact(ref, again)
    seen = {"jax": [], "port": []}

    def veto(who):
        def cb(it):
            seen[who].append(it)
            return it < 3
        return cb
    for who, fn in (("jax", JF), ("port", PF)):
        kw = {} if who == "jax" else {"device": "cpu"}
        with pytest.raises(fn.RoundInterrupted) as e:
            fn.pagerank_dense(snap, iterations=10, on_round=veto(who), **kw)
        assert e.value.rounds == 3
    assert seen["jax"] == seen["port"] == [0, 1, 2, 3]


def test_a_live_overlay_is_refused_an_empty_one_ignored():
    js = _random(42)
    ps = PS.from_numpy(js)
    oj = JaxOverlay(js, min_cap=256)
    op = DeltaOverlay(ps, min_cap=256, device="cpu")
    a, _ = PF.pagerank_dense(ps, iterations=3, overlay=op.view(),
                             device="cpu")
    _exact(JF.pagerank_dense(js, iterations=3, overlay=oj.view())[0], a)
    for ov in (oj, op):
        ov.append_edges(np.asarray([1, 2], np.int32),
                        np.asarray([2, 1], np.int32), np.zeros(2, np.int32))
    with pytest.raises(RuntimeError, match="overlay"):
        JF.pagerank_dense(js, overlay=oj.view())
    for call in (lambda: PF.pagerank_dense(ps, overlay=op.view(),
                                           device="cpu"),
                 lambda: PP.pagerank_personalized_batched(
                     ps, [0], overlay=op.view(), device="cpu")):
        with pytest.raises(RuntimeError, match="overlay"):
            call()
    ps._live_overlay = op.view()             # the attached view counts too
    with pytest.raises(RuntimeError, match="overlay"):
        PF.pagerank_dense(ps, device="cpu")


# --------------------------------------------------------------------------
# personalized PageRank, batched
# --------------------------------------------------------------------------

def _users(snap, S, seed=2):
    rng = np.random.default_rng(seed)
    nz = np.flatnonzero(snap.out_degree > 0)
    src = [int(x) for x in rng.choice(nz, S, replace=True)]
    src[1] = src[0]                          # two users on one vertex
    return src


@pytest.mark.parametrize("name", ["random42", "rmat11", "hubs", "path"])
def test_ppr_rows_bit_equal_to_dense_runs_and_to_jax(name):
    snap = GRAPHS[name]()
    src = _users(snap, 5)
    got, it = PP.pagerank_personalized_batched(snap, src, iterations=10,
                                               device="cpu")
    assert it == 10 and got.shape == (5, snap.n) and got.dtype == np.float32
    for s, v in enumerate(src):
        row, _ = PF.pagerank_dense(snap, iterations=10,
                                   reset=_one_hot(snap.n, v), device="cpu")
        _exact(row, got[s])
    ref, it_ref = JP.pagerank_personalized_batched(snap, src, iterations=10)
    assert it_ref == it
    _exact(ref, got)


def test_ppr_reset_rows_and_windows_match_jax(monkeypatch):
    snap = _rmat(8)
    rng = np.random.default_rng(6)
    reset = rng.random((3, snap.n)).astype(np.float32)
    reset /= reset.sum(axis=1, keepdims=True)
    for mod in (JF, PF):
        monkeypatch.setattr(mod, "DENSE_WINDOW", 37)
    ref, _ = JP.pagerank_personalized_batched(snap, reset=reset,
                                              iterations=6)
    got, _ = PP.pagerank_personalized_batched(snap, reset=reset,
                                              iterations=6, device="cpu")
    _exact(ref, got)
    for s in range(3):
        row, _ = PF.pagerank_dense(snap, iterations=6, reset=reset[s],
                                   device="cpu")
        _exact(row, got[s])


def test_ppr_veto_and_errors_match_jax():
    snap = _random(42)
    for fn, kw in ((JP, {}), (PP, {"device": "cpu"})):
        with pytest.raises(Exception) as e:
            fn.pagerank_personalized_batched(snap, [0, 1], iterations=5,
                                             on_round=lambda it: it < 2,
                                             **kw)
        assert type(e.value).__name__ == "RoundInterrupted"
        assert e.value.rounds == 2
        for bad, err in (({"sources": []}, ValueError),
                         ({"sources": None}, ValueError),
                         ({"sources": [snap.n]}, IndexError),
                         ({"sources": [-1]}, IndexError),
                         ({"reset": np.ones((2, 5), np.float32)},
                          ValueError),
                         ({"reset": np.ones(snap.n, np.float32)},
                          ValueError)):
            with pytest.raises(err):
                fn.pagerank_personalized_batched(snap, **bad, **kw)
    with pytest.raises(ValueError, match="reset"):
        PF.pagerank_dense(snap, reset=np.ones(3, np.float32), device="cpu")


@pytest.mark.parametrize("k", [0, -2, 1, 5, 400])
def test_top_k_per_user_equals_jax(k):
    """The per-user rows from the port's ranks: JAX's function on the same
    ranks gives the same rows, with and without each user's own vertex
    excluded, for k past n and k <= 0; a tensor is accepted too."""
    snap = _rmat(8)
    src = _users(snap, 4)
    ranks, _ = PP.pagerank_personalized_batched(snap, src, iterations=8,
                                                device="cpu")
    vids = np.asarray(snap.vertex_ids)
    for exclude in (None, src, [None, src[1], None, src[3]]):
        ref = JP.top_k_per_user(ranks, vids, k=k, exclude=exclude)
        got = PP.top_k_per_user(torch.from_numpy(ranks), vids, k=k,
                                exclude=exclude)
        assert got == ref
        if exclude is not None and k > 0:
            for s, row in enumerate(got):
                if exclude[s] is not None:
                    assert vids[exclude[s]] not in [v for v, _ in row]


def test_device_none_means_cuda(monkeypatch):
    snap = _random(42)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: PF.pagerank_dense(snap),
                 lambda: PP.pagerank_personalized_batched(snap, [0])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
