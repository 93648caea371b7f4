"""The port's batched [K, n] BFS (titan_tpu_torch.models.bfs_hybrid
.frontier_bfs_batched) against the JAX package's, on the CPU: ``dist``,
``levels`` and ``completed`` must be bit-equal.

The JAX function runs in its default XLA mode (its Pallas interpreter path
no longer runs under the installed jax); the port's rounds go through
``frontier_round``'s plain version, the same arithmetic the card's kernel
is held to. Every distinct K is a fresh XLA compile on the JAX side, so
the JAX reference is called with K in {1, 8} only; larger K (40: two
kernel job groups) is held to the port's own ``frontier_bfs_hybrid``
row by row."""

import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
import titan_tpu.models.bfs_hybrid as H
import titan_tpu_torch.models.bfs_hybrid as P
import titan_tpu_torch.ops.frontier as F
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu.olap.tpu.rmat import rmat_edges
from titan_tpu_torch.device import INF


def _sym(n, src, dst):
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    return snap_mod.from_arrays(n, np.concatenate([src, dst]),
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
    """Two hubs whose frontier neighbours sort after 100 others: past
    the chunk rounds, so the exhaust has to find them; plus a tail."""
    src = [0] * 81 + [200] * 101 + [201] * 60 + [300]
    dst = (list(range(1, 81)) + [300] + list(range(100, 200)) + [300]
           + list(range(202, 261)) + [300] + [301])
    return _sym(302, src, dst)


GRAPHS = {"random42": lambda: _random(42), "sparse": lambda: _random(1, 150),
          "rmat8": lambda: _rmat(8), "rmat11": lambda: _rmat(11),
          "hubs": _hubs}


def _sources(snap, K, seed):
    rng = np.random.default_rng(seed)
    nz = np.flatnonzero(snap.out_degree > 0)
    srcs = [int(s) for s in rng.choice(nz, size=K, replace=True)]
    if K > 1:
        srcs[1] = srcs[0]                  # a duplicate source
    return srcs


def _same(ref, got):
    d_ref, lv_ref, c_ref = ref
    d_got, lv_got, c_got = got
    assert d_got.dtype == np.int32 and lv_got.dtype == np.int32
    assert np.array_equal(np.asarray(d_ref), d_got)
    assert np.array_equal(lv_ref, lv_got)
    assert np.array_equal(c_ref, c_got)


def _both(snap, sources, **kw):
    return (H.frontier_bfs_batched(snap, sources, **kw),
            P.frontier_bfs_batched(snap, sources, device="cpu", **kw))


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_bit_equal_to_jax(name, K):
    snap = GRAPHS[name]()
    _same(*_both(snap, _sources(snap, K, 7)))


@pytest.mark.parametrize("name", ["random42", "rmat11", "hubs"])
def test_k40_rows_equal_single_source_runs(name):
    """K = 40 is two groups of the kernel's 32 jobs; every row equals the
    port's direction-optimizing BFS from that source."""
    snap = GRAPHS[name]()
    srcs = _sources(snap, 40, 3)
    dist, levels, completed = P.frontier_bfs_batched(snap, srcs,
                                                     device="cpu")
    assert dist.shape == (40, snap.n) and completed.all()
    for k, s in enumerate(srcs):
        ref, lv = P.frontier_bfs_hybrid(snap, s, device="cpu")
        assert np.array_equal(dist[k], ref), f"job {k} source {s}"
        # the batched level is where the frontier emptied: one past the
        # last level reached, the single-source run's level count
        assert levels[k] == ref[ref < INF].max() + 1 == lv


def test_on_level_drop_matches_jax():
    """Jobs dropped through the keep mask stop at that level (partial
    dist, completed False); the others finish bit-equal (as
    tests/test_serving.py's early-exit test, at K = 8)."""
    snap = _path()
    srcs = [0, 49, 10, 10, 25, 3, 40, 7]
    seen = {"jax": [], "port": []}

    def on_level(who):
        def cb(level, nf):
            seen[who].append((level, nf.tolist()))
            keep = np.ones(8, bool)
            if level >= 2:
                keep[0] = False
            if level >= 4:
                keep[3] = False
            return keep
        return cb
    ref = H.frontier_bfs_batched(snap, srcs, on_level=on_level("jax"))
    got = P.frontier_bfs_batched(snap, srcs, on_level=on_level("port"),
                                 device="cpu")
    _same(ref, got)
    assert seen["jax"] == seen["port"]
    assert not got[2][0] and not got[2][3] and got[2][1]
    assert got[1][0] == 2 and got[1][3] == 4
    assert (got[0][0][3:] >= INF).all()


def test_checkpoint_and_resume():
    """The checkpoint at a level boundary gets the same [K, n+1] state and
    active mask as JAX's; resuming from it through init_dist/start_level
    gives the uninterrupted run's result, bit-equal to JAX's resume."""
    snap = _rmat(8)
    srcs = _sources(snap, 8, 11)
    caps = {"jax": {}, "port": {}}

    def keep(who):
        def cb(level, dist, active):
            caps[who][level] = (np.array(dist), active.copy())
        return cb
    full_ref = H.frontier_bfs_batched(snap, srcs, checkpoint=keep("jax"))
    full = P.frontier_bfs_batched(snap, srcs, checkpoint=keep("port"),
                                  device="cpu")
    _same(full_ref, full)
    assert sorted(caps["jax"]) == sorted(caps["port"])
    for lv, (d, act) in caps["jax"].items():
        assert caps["port"][lv][0].shape == (8, snap.n + 1)
        assert np.array_equal(caps["port"][lv][0], d)
        assert np.array_equal(caps["port"][lv][1], act)
    d2, _ = caps["port"][2]
    # the captured state is a copy: the run went on past it
    assert not np.array_equal(d2[:, :snap.n], full[0])
    init = d2[:, :snap.n]
    ref = H.frontier_bfs_batched(snap, srcs, init_dist=init, start_level=2)
    got = P.frontier_bfs_batched(snap, srcs, init_dist=init, start_level=2,
                                 device="cpu")
    _same(ref, got)
    assert np.array_equal(got[0], full[0])
    # init_dist as a tensor resumes the same way
    got_t = P.frontier_bfs_batched(snap, srcs, start_level=2, device="cpu",
                                   init_dist=torch.from_numpy(init))
    _same(got, got_t)


def _hop_sets(snap, starts, depth):
    """Top-down hop sets with numpy: [depth+1] lists of bool [n] (hop 0 =
    the start set)."""
    dst_by_src, indptr = snap.out_csr()
    cur = np.zeros(snap.n, bool)
    cur[list(starts)] = True
    out = [cur]
    for _ in range(depth):
        nxt = np.zeros(snap.n, bool)
        for u in np.flatnonzero(cur):
            nxt[dst_by_src[indptr[u]:indptr[u + 1]]] = True
        out.append(nxt)
        cur = nxt
    return out


def _hops_encoding(sets, start_level):
    """dist of a hops run that swept every hop: the LAST hop h a vertex is
    in, stamped h + start_level; 0 where never reached."""
    d = np.zeros(sets[0].shape[0], np.int32)
    for h, s in enumerate(sets):
        d[s] = h + start_level
    return d


def test_hops_default_seeding_matches_jax():
    snap = _random(42)
    srcs = _sources(snap, 8, 5)
    ref, got = _both(snap, srcs, mode="hops", start_level=1, max_levels=4)
    _same(ref, got)
    for k, s in enumerate(srcs):
        assert np.array_equal(got[0][k],
                              _hops_encoding(_hop_sets(snap, [s], 3), 1))


def test_hops_multistart_padded_like_the_interactive_lane():
    """The interactive scheduler's shape: 3 multi-start jobs of depths
    2, 1, 3 padded to K = 4 with a depth-0 row that the level-1 keep mask
    retires. Each real row's final hop set equals a numpy top-down
    expansion; the same jobs padded to K = 8 give JAX's rows."""
    snap = _rmat(8)
    starts = [[3, 17], [40], [5, 6, 7]]
    depths = [2, 1, 3]

    def run(pkg, kp, **kw):
        dp = depths + [0] * (kp - 3)
        init = np.zeros((kp, snap.n), np.int32)
        for k, ds in enumerate(starts):
            init[k, ds] = 1

        def on_level(level, nf):
            keep = np.asarray([level <= d for d in dp])
            return keep if not keep.all() else None
        return pkg.frontier_bfs_batched(
            snap, [0] * kp, max_levels=max(depths) + 1, start_level=1,
            init_dist=init, on_level=on_level, mode="hops", **kw)
    got4 = run(P, 4, device="cpu")
    # the pad row has no frontier: it completes at level 1
    assert list(got4[1]) == [3, 2, 4, 1]
    assert list(got4[2]) == [False, False, True, True]
    assert (got4[0][3] == 0).all()
    for k in range(3):
        sets = _hop_sets(snap, starts[k], depths[k])
        assert np.array_equal(got4[0][k] == depths[k] + 1, sets[-1])
        assert np.array_equal(got4[0][k], _hops_encoding(sets, 1))
    ref8, got8 = run(H, 8), run(P, 8, device="cpu")
    _same(ref8, got8)
    assert np.array_equal(got8[0][:3], got4[0][:3])


def _slot_mask(snap, seed):
    g = H.build_chunked_csr(snap)
    rng = np.random.default_rng(seed)
    lm = rng.integers(0, 256, g["q_total"]).astype(np.uint8)
    lm[-1] = 0                            # the all-pad sink column
    return lm


@pytest.mark.parametrize("mode,masks", [
    ("hops", [None, 0]),                  # a None entry, shorter than run
    ("bfs", [0, None, 0])])
def test_level_masks_match_jax(mode, masks):
    import jax.numpy as jnp

    snap = _random(42)
    lm = _slot_mask(snap, 9)
    srcs = _sources(snap, 8, 2)
    kw = dict(mode=mode, start_level=1 if mode == "hops" else 0,
              max_levels=4 if mode == "hops" else 5)
    ref = H.frontier_bfs_batched(
        snap, srcs, level_masks=[None if m is None else jnp.asarray(lm)
                                 for m in masks], **kw)
    got = P.frontier_bfs_batched(
        snap, srcs, level_masks=[None if m is None else torch.from_numpy(lm)
                                 for m in masks], device="cpu", **kw)
    _same(ref, got)
    plain = P.frontier_bfs_batched(snap, srcs, device="cpu", **kw)
    assert not np.array_equal(plain[0], got[0])   # the masks did bite


def test_forced_exhaust_matches_jax(monkeypatch):
    """One chunk round a level, in both packages: every candidate with a
    second chunk goes to the exhaustive sweep."""
    for mod in (H, P):
        monkeypatch.setattr(mod, "BU_CHUNK_ROUNDS", 1)
    calls = []
    real = P._batched_exhaust
    monkeypatch.setattr(P, "_batched_exhaust",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for name in ("hubs", "rmat8"):
        snap = GRAPHS[name]()
        _same(*_both(snap, _sources(snap, 8, 4)))
    assert calls


def test_sliced_exhaust_equals_unsliced(monkeypatch):
    """Slices of 3 pairs fold to what one slice gives, in the per-
    candidate hits and in the whole BFS (bfs and hops mode); the hits are
    the JAX package's [K, 8, P] test of job-major bitmaps, folded by
    owner over the live pairs."""
    rng = np.random.default_rng(0)
    K, C, Q, nv, P_ = 5, 37, 300, 500, 211
    rows = rng.integers(0, 256, (K, (nv + 9) // 8)).astype(np.uint8)
    tbits = torch.from_numpy(rng.integers(0, 256, Q).astype(np.uint8))
    dstT = torch.from_numpy(rng.integers(0, nv + 2, (8, Q)).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, Q, P_).astype(np.int32))
    # dead pairs read the all-pad sink column, as enumerate_chunk_pairs
    # gives them, so their hits are 0
    dstT[:, Q - 1] = nv + 1
    cols[190:] = Q - 1
    rows[:, (nv + 1) >> 3] = 0            # no bit of the pad vertex
    fbits = cs.rows_to_words(torch.from_numpy(rows), K)
    owner = torch.from_numpy(np.sort(rng.integers(0, C, P_))
                             .astype(np.int32))
    p_total = torch.tensor(190, dtype=torch.int32)

    def sweep(t):
        return F.batched_exhaust(cols, owner, p_total, fbits, t, dstT, K=K,
                                 c_cap=C)
    whole = {t: sweep(t) for t in (None, tbits)}
    monkeypatch.setattr(F, "EXHAUST_SLICE", 3)
    for t in (None, tbits):
        assert torch.equal(sweep(t), whole[t])
    # one [K, 8, P] test of the job-major bitmaps, the JAX package's form
    par = dstT[:, cols.long()].numpy()
    hit = ((rows[:, par >> 3] >> (par & 7)[None]) & 1).any(axis=1)
    ref = np.zeros((K, C), bool)
    for j in range(190):
        ref[:, owner[j]] |= hit[:, j]
    assert np.array_equal(whole[None].numpy(), ref)
    snap = _hubs()
    srcs = _sources(snap, 8, 4)
    for mode, lv0 in (("bfs", 0), ("hops", 1)):
        sliced = P.frontier_bfs_batched(snap, srcs, mode=mode,
                                        start_level=lv0, max_levels=6,
                                        device="cpu")
        monkeypatch.setattr(F, "EXHAUST_SLICE", 1 << 22)
        _same(P.frontier_bfs_batched(snap, srcs, mode=mode, start_level=lv0,
                                     max_levels=6, device="cpu"), sliced)
        monkeypatch.setattr(F, "EXHAUST_SLICE", 3)


@pytest.mark.parametrize("expand", [False, True])
def test_plain_store_equals_the_min_max_scatter(expand):
    """_stamp plus the column write-back equals JAX's
    ``dist.at[:, where(alive, v, n+1)].min/.max(where(found, level+1,
    identity), mode="drop")`` whenever found implies undecided: in BFS
    mode found entries are >= INF, so a plain store is the min; in hops
    mode the store is masked where the max keeps a larger value (rows
    seeded with INF through init_dist)."""
    rng = np.random.default_rng(1 + expand)
    K, n, C, level = 6, 300, 128, 4
    if expand:
        dist = rng.integers(0, level + 2, (K, n + 2)).astype(np.int32)
        dist[rng.random((K, n + 2)) < 0.1] = INF
    else:
        dist = np.where(rng.random((K, n + 2)) < 0.5, INF,
                        rng.integers(0, level + 1, (K, n + 2))) \
            .astype(np.int32)
    dist[:, n] = INF
    alive = np.arange(C) < 100
    v = np.where(alive, rng.permutation(n)[:C], n)
    g = dist[:, v]
    undec = ((g != level + 1) if expand else (g >= INF)) & alive
    found = undec & (rng.random((K, C)) < 0.5)
    ref = dist.copy()
    idx = np.where(alive, v, n + 1)
    for k in range(K):
        for j in range(C):
            if idx[j] > n:
                continue                   # JAX's mode="drop"
            if expand:
                val = level + 1 if found[k, j] else 0
                ref[k, idx[j]] = max(ref[k, idx[j]], val)
            else:
                val = level + 1 if found[k, j] else INF
                ref[k, idx[j]] = min(ref[k, idx[j]], val)
    got = torch.from_numpy(dist.copy())
    gd = got[:, torch.from_numpy(v)]
    P._stamp(gd, torch.from_numpy(found), level, expand)
    got.index_copy_(1, torch.from_numpy(v), gd)
    assert np.array_equal(got.numpy()[:, :n + 1], ref[:, :n + 1])
    if not expand:                         # found entries were all >= INF
        assert (g[found] >= INF).all()


def test_pack_bits_batched_matches_numpy():
    rng = np.random.default_rng(3)
    K, n, level = 5, 203, 2
    dist = rng.integers(0, 4, (K, n + 2)).astype(np.int32)
    dist[:, n + 1] = level                 # the spare never packs
    active = np.array([True, False, True, True, False])
    fb = P._pack_bits_batched(torch.from_numpy(dist),
                              torch.from_numpy(active), level, n)
    nbytes = (n + 2 + 7) // 8
    mask = np.zeros((K, nbytes * 8), bool)
    mask[:, :n + 1] = (dist[:, :n + 1] == level) & active[:, None]
    # K = 5: one plane of 8-bit words, a byte a vertex
    assert fb.dtype == torch.uint8 and fb.shape == (1, n + 2)
    words = cs.rows_to_words(torch.from_numpy(
        np.packbits(mask, axis=1, bitorder="little")), K)
    assert np.array_equal(fb.numpy(), words[:, :n + 2].numpy())
    assert not words[:, n + 2:].any()
    idx = torch.from_numpy(rng.integers(0, n + 2, (3, 7)).astype(np.int32))
    got = P._bit_of_batched(fb, idx, K)
    assert got.shape == (K, 3, 7)
    assert np.array_equal(got.numpy(), mask[:, idx.numpy()])


def test_return_device_and_the_wrapper_path(monkeypatch):
    """return_device keeps a [K, n] tensor; the rounds go through
    frontier_round with K jobs."""
    snap = _random(42)
    srcs = _sources(snap, 8, 7)
    seen = []
    real = P.frontier_round

    def spy(*a, **k):
        seen.append((a[1].shape[0], a[6] is not None))
        return real(*a, **k)
    monkeypatch.setattr(P, "frontier_round", spy)
    d, lv, c = P.frontier_bfs_batched(snap, srcs, device="cpu",
                                      return_device=True)
    assert torch.is_tensor(d) and d.shape == (8, snap.n)
    assert seen and all(k == 8 and not masked for k, masked in seen)
    _same(H.frontier_bfs_batched(snap, srcs), (d.numpy(), lv, c))


def test_errors_match_jax():
    snap = _random(42)
    g = P.build_chunked_csr(snap, device="cpu")
    tomb = types.SimpleNamespace(empty=False, tomb_count=1, count=0,
                                 tomb_dev=torch.zeros(4, dtype=torch.uint8))
    tomb_j = types.SimpleNamespace(empty=False, tomb_count=1, count=0)
    cases = [
        (ValueError, dict(sources=[0], level_masks=[None], overlay=tomb),
         dict(overlay=tomb_j)),
        (ValueError, dict(sources=[0], mode="dfs"), {}),
        (ValueError, dict(sources=[0], mode="hops", start_level=0), {}),
        (ValueError, dict(sources=[]), {}),
        (IndexError, dict(sources=[0, snap.n + 5]), {}),
        (IndexError, dict(sources=[-1]), {}),
        (ValueError, dict(sources=[0, 1],
                          init_dist=np.zeros((2, snap.n - 1), np.int32)), {}),
    ]
    for exc, kw, jax_kw in cases:
        with pytest.raises(exc):
            P.frontier_bfs_batched(snap, device="cpu", **kw)
        with pytest.raises(exc):
            H.frontier_bfs_batched(snap, **{**kw, **jax_kw})
    with pytest.raises(NotImplementedError, match="item 9"):
        P.frontier_bfs_batched({**g, "_state_sharding": object()}, [0],
                               device="cpu")


def test_device_checks(monkeypatch):
    snap = _random(42)
    g = P.build_chunked_csr(snap, device="cpu")
    view = types.SimpleNamespace(empty=False, tomb_count=0, count=1,
                                 tomb_dev=torch.zeros(4, dtype=torch.uint8,
                                                      device="meta"))
    with pytest.raises(ValueError, match="overlay lies on"):
        P.frontier_bfs_batched(g, [0], overlay=view, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.frontier_bfs_batched(g, [0])
