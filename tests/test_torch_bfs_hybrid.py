"""The port's direction-optimizing BFS (titan_tpu_torch.models.bfs_hybrid)
against the JAX package's frontier_bfs_hybrid in its default XLA mode,
on the CPU: ``dist`` and the level count must be bit-equal.

Each graph runs with the default thresholds (the head loop and the
endgame take most levels at this size) and with the ``force_bu`` idiom
of tests/test_pallas_frontier.py, set in BOTH packages, which routes the
levels through the top-down steps, the bottom-up opener and chunk
rounds (frontier_round's plain version) and the exhaustive sweep."""

import types

import numpy as np
import pytest
import torch

import titan_tpu.models.bfs_hybrid as H
import titan_tpu_torch.models.bfs_hybrid as P
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu.olap.tpu.rmat import rmat_edges


def _sym(n, src, dst):
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    return snap_mod.from_arrays(n, np.concatenate([src, dst]),
                                np.concatenate([dst, src]))


def _random(seed):
    rng = np.random.default_rng(seed)
    return _sym(192, rng.integers(0, 192, 900), rng.integers(0, 192, 900))


def _rmat(scale):
    src, dst = rmat_edges(scale, 16, seed=scale)
    return _sym(1 << scale, src, dst)


def _chain():
    return _sym(300, np.arange(299), np.arange(1, 300))


def _isolated():
    return _sym(5, [1, 2], [2, 3])


def _hub():
    ring = range(48, 56)
    return _sym(64, [0] * 47 + list(ring),
                list(range(1, 48)) + [v + 1 if v + 1 in ring else ring.start
                                      for v in ring])


def _exhaust():
    """Source 0 reaches 1..80 and 300; hub 200's only frontier neighbour
    at level 1 is 300, which sorts after its 100 other neighbours — past
    the 8 chunk rounds, so the exhaustive sweep has to find it."""
    src = [0] * 81 + [200] * 101
    dst = list(range(1, 81)) + [300] + list(range(100, 200)) + [300]
    return _sym(301, src, dst)


GRAPHS = {
    "random0": lambda: _random(0), "random1": lambda: _random(1),
    "random2": lambda: _random(2),
    **{f"rmat{s}": (lambda s=s: _rmat(s)) for s in range(8, 13)},
    "chain": _chain, "isolated": _isolated, "hub": _hub,
    "exhaust": _exhaust,
}
SOURCES = {"chain": 0, "isolated": 0, "hub": 0, "exhaust": 0}


def force_bu(monkeypatch):
    """tests/test_pallas_frontier.py's idiom, in both packages."""
    monkeypatch.setattr(H, "SPLIT_LANE_MIN", 2)
    for mod in (H, P):
        monkeypatch.setattr(mod, "END_C_CAP", 0)
        monkeypatch.setattr(mod, "END_P_CAP", 0)
        monkeypatch.setattr(mod, "HEAD_F_CAP", 1)


def _source(name, snap):
    if name in SOURCES:
        return SOURCES[name]
    return int(np.flatnonzero(snap.out_degree > 0)[0])


@pytest.mark.parametrize("forced", [False, True], ids=["default", "force_bu"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_bit_equal_to_jax(name, forced, monkeypatch):
    monkeypatch.delenv("TITAN_TPU_FRONTIER_KERNEL", raising=False)
    if forced:
        force_bu(monkeypatch)
    snap = GRAPHS[name]()
    src = _source(name, snap)
    d_ref, lv_ref = H.frontier_bfs_hybrid(snap, src)
    d_got, lv_got = P.frontier_bfs_hybrid(snap, src, device="cpu")
    assert d_got.dtype == np.int32
    assert np.array_equal(np.asarray(d_ref), d_got)
    assert lv_got == lv_ref


@pytest.mark.parametrize("max_levels", [0, 2, 3])
def test_max_levels_truncates_like_jax(max_levels):
    snap = _chain()
    d_ref, lv_ref = H.frontier_bfs_hybrid(snap, 0, max_levels=max_levels)
    d_got, lv_got = P.frontier_bfs_hybrid(snap, 0, max_levels=max_levels,
                                          device="cpu")
    assert np.array_equal(np.asarray(d_ref), d_got) and lv_got == lv_ref


def _count_calls(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(P, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(P, name, counted)
    return calls


def test_force_bu_reaches_every_level_step(monkeypatch):
    """The exhaust graph under force_bu runs the head, a top-down step
    with its lazy frontier list, the bottom-up opener, the chunk rounds
    and the exhaustive sweep; the default thresholds end in the
    endgame."""
    steps = ["_head_loop", "_td_step", "_frontier_of", "_bu_open",
             "_bu_rounds", "_bu_exhaust", "_endgame"]
    calls = _count_calls(monkeypatch, steps)
    P.frontier_bfs_hybrid(_exhaust(), 0, device="cpu")
    assert calls["_endgame"] == 1
    force_bu(monkeypatch)
    calls.update(dict.fromkeys(steps, 0))
    P.frontier_bfs_hybrid(_exhaust(), 0, device="cpu")
    assert all(calls[s] > 0 for s in steps if s != "_endgame"), calls


def test_pad_index_n_plus_1():
    """Pad lanes (index n+1) are dropped by the scatters and read the
    never-written dist[n] (INF) through the clamped gather, as JAX's
    mode="drop" scatter and clamping gather do."""
    g = P.build_chunked_csr(_hub(), device="cpu")
    n = g["n"]
    assert (g["dstT"][:, -1] == n + 1).all()          # the sink column
    dist = torch.full((n + 2,), P.INF, dtype=torch.int32)
    dist[0] = 0
    frontier = torch.tensor([0, n], dtype=torch.int32)
    st = P._td_step(dist, frontier, 1, 0, g, 64)
    assert int(dist[n]) == P.INF
    assert (dist[1:48] == 1).all() and (dist[48:n] == P.INF).all()
    # 47 children, one chunk each; the ring's 8 vertices stay unvisited
    assert st.tolist() == [47, 47, 8, 8]
    fbits = P._pack_bits(dist, 1, n)
    assert fbits.shape[0] == (n + 2 + 7) // 8
    ref = np.packbits(np.concatenate([dist[:n + 1].numpy() == 1,
                                      np.zeros(7, bool)])[:fbits.shape[0] * 8],
                      bitorder="little")
    assert np.array_equal(fbits.numpy(), ref)
    assert not P._bit_of(fbits, torch.tensor([n + 1], dtype=torch.int32))[0]


def test_enumerate_chunk_pairs_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    f_cap, p_cap, q_pad = 32, 48, 500
    valid = rng.random(f_cap) < 0.7
    counts = rng.integers(0, 5, f_cap).astype(np.int32)
    colstarts = rng.integers(0, 400, f_cap).astype(np.int32)
    ref = H.enumerate_chunk_pairs(jnp.asarray(valid), jnp.asarray(counts),
                                  jnp.asarray(colstarts), p_cap, q_pad,
                                  with_owner=True)
    got = P.enumerate_chunk_pairs(torch.from_numpy(valid),
                                  torch.from_numpy(counts),
                                  torch.from_numpy(colstarts), p_cap, q_pad,
                                  with_owner=True)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_live_overlay_raises():
    snap = types.SimpleNamespace(_live_overlay=types.SimpleNamespace(
        empty=False))
    with pytest.raises(RuntimeError, match="live overlay"):
        P.frontier_bfs_hybrid(snap, 0, device="cpu")


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.frontier_bfs_hybrid(_hub(), 0)
    g = P.build_chunked_csr(_hub(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.frontier_bfs_hybrid(g, 0)
