"""The port's single-launch BFS (titan_tpu_torch.models.bfs_hybrid_fused,
its plain version on the CPU) against the JAX package's
frontier_bfs_hybrid_fused, on the cases of tests/test_frontier_models.py:
``dist`` bit-equal, and ``levels`` equal to the JAX program's count,
which is not always frontier_bfs_hybrid's (ROADMAP queue 3, item 15).

The endgame caps are set in BOTH packages where a case sets them. JAX
caches its compiled program with the caps it was traced under, so every
test drops ``jitcache._JITS["hybrid_fused"]`` before and after it."""

import numpy as np
import pytest
import torch

import titan_tpu.models.bfs_hybrid as H
import titan_tpu.models.bfs_hybrid_fused as FU
import titan_tpu_torch.models.bfs_hybrid as PH
import titan_tpu_torch.models.bfs_hybrid_fused as PF
from titan_tpu.models.bfs import frontier_bfs
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu.olap.tpu.rmat import rmat_edges
from titan_tpu.utils import jitcache

#: every mode a case's plain run took, gathered across the file
SEEN_MODES: set = set()


@pytest.fixture(autouse=True)
def _fresh_jit(monkeypatch):
    monkeypatch.delitem(jitcache._JITS, "hybrid_fused", raising=False)
    yield
    jitcache._JITS.pop("hybrid_fused", None)


def _caps(monkeypatch, c, p):
    for mod in (FU, PF):
        monkeypatch.setattr(mod, "END_C_CAP", c)
        monkeypatch.setattr(mod, "END_P_CAP", p)


def _sym(n, src, dst):
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    return snap_mod.from_arrays(n, np.concatenate([src, dst]),
                                np.concatenate([dst, src]))


def _random(seed):
    """tests/test_frontier_models.py's sym_snap draw for ``seed``."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(80, 400))
    m = int(rng.integers(2 * n, 8 * n))
    return _sym(n, rng.integers(0, n, m).astype(np.int32),
                rng.integers(0, n, m).astype(np.int32))


def _rmat(scale, ef=8, seed=4):
    src, dst = rmat_edges(scale, ef, seed=seed)
    return _sym(1 << scale, src, dst)


def _path(n=300):
    return _sym(n, np.arange(n - 1), np.arange(1, n))


def _first(snap):
    return int(np.flatnonzero(snap.out_degree > 0)[0])


def _port(snap, source, **kw):
    """The port's fused BFS on the CPU, with the modes it took."""
    g = PH.build_chunked_csr(snap, "cpu")
    g["_trace_modes"] = trace = []
    try:
        dist, levels = PF.frontier_bfs_hybrid_fused(snap, source,
                                                    device="cpu", **kw)
    finally:
        del g["_trace_modes"]
    SEEN_MODES.update(m for _, m, _ in trace)
    return dist, levels, trace


def _same(snap, source, **kw):
    dj, lj = FU.frontier_bfs_hybrid_fused(snap, source, **kw)
    dp, lp, trace = _port(snap, source, **kw)
    assert np.array_equal(np.asarray(dj), dp)
    assert lp == lj, (lp, lj, trace)
    return dp, lp, trace


@pytest.mark.parametrize("seed", [4, 5])
def test_both_modes_without_the_endgame(seed, monkeypatch):
    _caps(monkeypatch, 1, 1)
    snap = _random(seed)
    source = _first(snap)
    dist, _, trace = _same(snap, source)
    d_ref, _ = frontier_bfs(snap, source)
    assert np.array_equal(d_ref, dist)
    assert {m for _, m, _ in trace} >= {"td", "bu"}


@pytest.mark.parametrize("scale", [8, 10, 11, 12, 14])
def test_rmat_default_endgame(scale):
    snap = _rmat(scale)
    dist, _, trace = _same(snap, _first(snap))
    d_hyb, _ = PH.frontier_bfs_hybrid(snap, _first(snap), device="cpu")
    assert np.array_equal(d_hyb, dist)
    assert trace[-1][1] == "endgame"


@pytest.mark.parametrize("scale", [8, 11, 13])
def test_rmat_every_level_through_td_and_bu(scale, monkeypatch):
    _caps(monkeypatch, 1, 1)
    snap = _rmat(scale, ef=16, seed=scale)
    dist, _, trace = _same(snap, _first(snap))
    d_hyb, _ = PH.frontier_bfs_hybrid(snap, _first(snap), device="cpu")
    assert np.array_equal(d_hyb, dist)
    assert {m for _, m, _ in trace} >= {"td", "bu"}


def test_the_192_vertex_shape():
    rng = np.random.default_rng(42)
    snap = _sym(192, rng.integers(0, 192, 900), rng.integers(0, 192, 900))
    for source in (0, 7, 191):
        _same(snap, source)


def test_path_graph(monkeypatch):
    _caps(monkeypatch, 1, 1)
    snap = _path()
    dist, levels, _ = _same(snap, 0)
    d_ref, _ = frontier_bfs(snap, 0)
    assert np.array_equal(d_ref, dist) and levels >= 299


@pytest.mark.parametrize("max_levels", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("caps", [None, 1])
def test_max_levels_truncation(max_levels, caps, monkeypatch):
    if caps is not None:
        _caps(monkeypatch, caps, caps)
    snap = _rmat(11)
    _same(snap, _first(snap), max_levels=max_levels)


def test_max_levels_truncates_the_path_inside_the_endgame():
    snap = _path()
    dist, levels, trace = _same(snap, 0, max_levels=40)
    assert levels == 40 and trace == [(0, "endgame", trace[0][2])]
    assert dist[40] == 40 and dist[41] >= PF.INF


def test_overflow_configuration_has_no_rerun(monkeypatch):
    """JAX's bottom-up ladder monkeypatched tiny (tests/test_frontier_
    models.py:374-410): JAX flags the overflow and re-runs through the
    host-driven hybrid. The port has no ladder and no re-run: the same
    dist, and the levels of JAX's fused run at its normal ladder."""
    _caps(monkeypatch, 1, 1)
    snap = _rmat(11, seed=6)
    source = _first(snap)
    d_normal, l_normal = FU.frontier_bfs_hybrid_fused(snap, source)
    jitcache._JITS.pop("hybrid_fused", None)
    orig = FU._ladders

    def tiny_ladders(n, total_chunks):
        td, bu, cap_n, cap_q = orig(n, total_chunks)
        return td, [8], cap_n, cap_q

    monkeypatch.setattr(FU, "_ladders", tiny_ladders)
    called = []
    real = H.frontier_bfs_hybrid

    def spy(*a, **kw):
        called.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(H, "frontier_bfs_hybrid", spy)
    d_over, l_over = FU.frontier_bfs_hybrid_fused(snap, source)
    assert called, "JAX's overflow did not re-run host-driven"
    dp, lp, trace = _port(snap, source)
    assert np.array_equal(np.asarray(d_over), dp)
    assert np.array_equal(np.asarray(d_normal), dp)
    assert lp == l_normal
    assert "bu" in {m for _, m, _ in trace}


@pytest.mark.parametrize("case", ["rmat9", "path"])
def test_fused_counts_one_level_more_than_the_hybrid(case, monkeypatch):
    """Pins ROADMAP queue 3 item 15 in both packages: an endgame that
    ends by finding nothing counts the empty level and then the probe,
    one level more than frontier_bfs_hybrid, whose docstring the fused
    function's promises to match."""
    if case == "rmat9":
        snap = _rmat(9)
        source = _first(snap)
    else:
        _caps(monkeypatch, 1, 1)
        snap, source = _path(), 0
    _, lj = FU.frontier_bfs_hybrid_fused(snap, source)
    _, lh = H.frontier_bfs_hybrid(snap, source)
    _, lp, _ = _port(snap, source)
    _, lph = PH.frontier_bfs_hybrid(snap, source, device="cpu")
    assert lj == lp == lh + 1 == lph + 1


def test_chunked_csr_dict_and_return_device():
    snap = _rmat(10)
    source = _first(snap)
    g = PH.build_chunked_csr(snap, "cpu")
    d_dict, l_dict = PF.frontier_bfs_hybrid_fused(g, source, device="cpu",
                                                  return_device=True)
    d_snap, l_snap = PF.frontier_bfs_hybrid_fused(snap, source,
                                                  device="cpu")
    assert isinstance(d_dict, torch.Tensor) and d_dict.shape == (snap.n,)
    assert np.array_equal(d_dict.numpy(), d_snap) and l_dict == l_snap


def test_plain_slices_give_the_same_result(monkeypatch):
    """The plain version's gathers go in slices of SLICE chunk columns;
    tiny slices (items never split) change no result."""
    _caps(monkeypatch, 1, 1)
    snap = _rmat(10, ef=16, seed=3)
    source = _first(snap)
    want, lw, tw = _port(snap, source)
    monkeypatch.setattr(PF, "SLICE", 3)
    monkeypatch.setattr(PF, "BU_CHUNK_ROUNDS", 1)
    got, lg, tg = _port(snap, source)
    assert np.array_equal(want, got) and lw == lg
    assert [m for _, m, _ in tw] == [m for _, m, _ in tg]


def test_the_mode_rule():
    top = PF.td_top(1 << 26, 282177704)
    assert top == (1 << 23, 1 << 25)
    assert PF.td_top(100, 50) == (128, 64)
    assert PF.end_caps(100, 50) == (128, 64)
    end = (4, 4)
    assert PF.choose_mode([9, 9, 4, 4], *end, top) == 0
    assert PF.choose_mode([9, 9, 80, 5], *end, top) == 1      # 9 <= 80 // 8
    assert PF.choose_mode([9, 11, 80, 5], *end, top) == 2
    assert PF.choose_mode([1, 11, 80, 5], *end, top) == 1     # f == 1
    assert PF.choose_mode([1, (1 << 25) + 1, 1 << 30, 5], *end, top) == 2
    assert PF.choose_mode([(1 << 23) + 1, 1, 1 << 30, 5], *end, top) == 2


def test_a_card_is_required_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PF.frontier_bfs_hybrid_fused(_path(10), 0)
    g = PH.build_chunked_csr(_path(10), "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        PF._launch(g, 0, 10)
    assert PF.fused_bfs.launches == 0


def _bound_by_hand(g, dist, trace) -> dict:
    """chip_smoke.fused_bytes's model, vertex by vertex in numpy."""
    n = g["n"]
    dstT, cs, dg = (g[k].numpy() for k in ("dstT", "colstart", "degc"))
    d = dist[:n].numpy().astype(np.int64)
    out = {"dstT_td": 0, "dist_td": 0, "dstT_bu": 0, "bitmaps": 0}

    def bottom_up(level):
        found = 0
        for v in np.flatnonzero((d > level) & (dg[:n] > 0)):
            if d[v] != level + 1:
                out["dstT_bu"] += 32 * int(dg[v])
                continue
            found += 1
            first = next(j for j in range(dg[v]) if any(
                w < n and d[w] == level for w in dstT[:, cs[v] + j]))
            out["dstT_bu"] += 32 * (first + 1)
        out["bitmaps"] += 2 * (-(-(n + 2) // 8))
        return found

    for level, mode, _ in trace:
        if mode == "td":
            sectors = set()
            for u in np.flatnonzero(d == level):
                out["dstT_td"] += 32 * int(dg[u])
                cols = dstT[:, cs[u]:cs[u] + dg[u]].reshape(-1)
                sectors.update(int(w) >> 3 for w in cols if w < n)
            out["dist_td"] += 32 * len(sectors)
        elif mode == "bu":
            bottom_up(level)
        else:
            lvl = level
            while bottom_up(lvl):
                lvl += 1
    return out


@pytest.mark.parametrize("caps", [None, (1, 1)])
@pytest.mark.parametrize("rounds", [0, 1, 8])
def test_smoke_bound_counts_what_each_level_reads(caps, rounds,
                                                  monkeypatch):
    """chip_smoke.fused_bytes, the fused kernel's byte bound, counts what
    each level's decision must read (a bottom-up vertex's chunks up to
    its first parent, a top-down level's distinct dist sectors), however
    many one-chunk rounds it takes before its sweep."""
    import chip_smoke as cs

    if caps:
        _caps(monkeypatch, *caps)
    snap = _rmat(10, ef=16, seed=10)
    g = PH.build_chunked_csr(snap, "cpu")
    dist, _, trace = cs.fused_plain(PF, g, int(np.argmax(snap.out_degree)))
    SEEN_MODES.update(m for _, m, _ in trace)
    first_hit = cs._first_hit_chunks
    monkeypatch.setattr(cs, "_first_hit_chunks",
                        lambda *a: first_hit(*a, rounds=rounds))
    got = cs.fused_bytes(PF, g, dist, trace)
    want = _bound_by_hand(g, dist, trace)
    assert {k: got[k] for k in want} == want
    assert got["total"] == sum(want.values()) + got["once"]
    assert got["plain"] == 32 * sum(c for _, _, c in trace) + got["once"]


def test_every_mode_was_exercised():
    """Runs last in this file: across its cases the plain version took
    the endgame, top-down and bottom-up."""
    assert SEEN_MODES >= {"endgame", "td", "bu"}, SEEN_MODES
