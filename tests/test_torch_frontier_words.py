"""The batched BFS's vertex-major frontier words (titan_tpu_torch.ops
.frontier's module doc) and the plain version of the batched straggler
sweep, on the CPU.

The words hold the bits of the JAX package's job-major [K, nbytes]
bitmaps in another order: Kp = min(next_pow2(K), 32) bits a vertex in
each plane of 32 jobs. These tests hold the packer and the bit test to
the job-major form for every word width and plane count, the plain round
on words to the numpy oracle of tests/test_pallas_frontier.py, the plain
sweep to the JAX package's ``_batched_exhaust`` (the ``dist`` it
returns, in BFS and hops mode, with and without tombstones, with fewer
live pairs than listed ones), and the hops mode's ``live`` jobs, now
taken from the plan's frontier counts, to the job-major bitmaps' nonzero
rows. The CUDA kernels are held to these plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import titan_tpu.models.bfs_hybrid as H
import titan_tpu_torch.models.bfs_hybrid as P
import titan_tpu_torch.ops.frontier as F
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu_torch.device import INF, next_pow2

WORD_KS = [1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 40]


def _graph(seed=42, n=192, m=900):
    """The shared n=192/m=900/seed-42 symmetric random graph."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    return snap_mod.from_arrays(n, np.concatenate([src, dst]),
                                np.concatenate([dst, src]))


def _dist(rng, K, n, level, expand):
    """A [K, n+2] state: levels up to ``level`` and INF (BFS), or hop
    stamps 0..level+1 with a few INF (hops); column n INF."""
    if expand:
        d = rng.integers(0, level + 2, (K, n + 2))
        d[rng.random((K, n + 2)) < 0.05] = INF
    else:
        d = np.where(rng.random((K, n + 2)) < 0.5, INF,
                     rng.integers(0, level + 1, (K, n + 2)))
    d[:, n] = INF
    return d.astype(np.int32)


@pytest.mark.parametrize("K", WORD_KS)
def test_words_round_trip(K):
    """_pack_bits_batched's words read back through _bit_of_batched as
    the job-major mask, equal chip_smoke.rows_to_words of the JAX
    package's packed bitmaps, and keep the pad vertex n+1 and every bit
    past it zero."""
    rng = np.random.default_rng(K)
    n, level = 203, 2
    dist = _dist(rng, K, n, level, False)
    dist[:, n + 1] = level                     # the spare never packs
    active = rng.random(K) < 0.8
    fb = P._pack_bits_batched(torch.from_numpy(dist),
                              torch.from_numpy(active), level, n)
    Kp, G = F.word_bits(K)
    assert Kp == min(next_pow2(K), 32) if K > 1 else Kp == 1
    assert fb.dtype == torch.uint8
    assert fb.shape == (G, F.plane_bytes(n + 2, K))
    mask = np.zeros((K, n + 2), bool)
    mask[:, :n + 1] = (dist[:, :n + 1] == level) & active[:, None]
    idx = torch.arange(n + 2, dtype=torch.int32)
    assert np.array_equal(P._bit_of_batched(fb, idx, K).numpy(), mask)
    rows = np.array(H._pack_bits_batched(jnp.asarray(dist[:, :n + 1]),
                                         jnp.asarray(active), level, n))
    words = cs.rows_to_words(torch.from_numpy(rows), K)
    assert torch.equal(fb, words[:, :fb.shape[1]])
    assert not words[:, fb.shape[1]:].any()
    assert torch.equal(cs.words_to_rows(fb, K)[:, :rows.shape[1]],
                       torch.from_numpy(rows))


@pytest.mark.parametrize("Kp", [1, 2, 4, 8, 16, 32])
def test_words_at_clamps_as_stated(Kp):
    """Out-of-range parents read the word the module doc states: Kp >= 8
    the clamped word index, below it the clamped byte at bit
    (par*Kp) & 7; Kp = 1 is the single-source bitmap's rule."""
    rng = np.random.default_rng(Kp)
    nb = 24
    plane = rng.integers(0, 256, nb).astype(np.uint8)
    par = np.concatenate([np.arange(-40, 0), rng.integers(0, 300, 64),
                          [2**31 - 1, -2**31]]).astype(np.int32)
    got = F.words_at(torch.from_numpy(plane), torch.from_numpy(par), Kp)
    p = par.astype(np.int64)
    if Kp >= 8:
        w = np.clip(p, 0, nb * 8 // Kp - 1) * (Kp // 8)
        exp = sum(plane[w + i].astype(np.int64) << (8 * i)
                  for i in range(Kp // 8))
    else:
        bit = p * Kp
        exp = (plane[np.clip(bit >> 3, 0, nb - 1)].astype(np.int64)
               >> (bit & 7)) & ((1 << Kp) - 1)
    assert np.array_equal(got.numpy().astype(np.int64) & (2**Kp - 1),
                          exp)
    if Kp == 1:
        old = (plane[np.clip(p >> 3, 0, nb - 1)] >> (p & 7)) & 1
        assert np.array_equal(got.numpy(), old)


@pytest.mark.parametrize("K", [2, 16, 40])
@pytest.mark.parametrize("lanes", [2, 8])
def test_reference_round_on_words_matches_oracle(K, lanes):
    """The plain round on words equals the numpy oracle of
    tests/test_pallas_frontier.py on the same bits, job-major."""
    rng = np.random.default_rng(K + lanes)
    C, Q, n_val = 90, 61, 300
    dstT = rng.integers(0, n_val + 1, (8, Q)).astype(np.int32)
    cols = rng.integers(0, Q, C).astype(np.int32)
    undec = rng.random((K, C)) < 0.7
    has_more = rng.random(C) < 0.6
    pay0 = rng.integers(0, n_val, C).astype(np.int32)
    pay1 = rng.integers(0, 8, C).astype(np.int32)
    rows = (rng.integers(0, 256, (K, (n_val + 9) // 8))
            & rng.integers(0, 256, (K, (n_val + 9) // 8))).astype(np.uint8)
    tbits = rng.integers(0, 256, Q).astype(np.uint8)
    t = torch.from_numpy
    found, p0, p1, nsur = F.frontier_round(
        t(cols), t(undec), t(has_more), t(pay0), t(pay1),
        cs.rows_to_words(t(rows), K), t(tbits), t(dstT), lanes=lanes,
        fill0=-7, fill1=-9)
    par = dstT[:, cols]
    hit = (rows[:, par >> 3] >> (par & 7)[None]) & 1
    slot = cols[None, :].astype(np.int64) * 8 + np.arange(8)[:, None]
    hit = (hit & ~((tbits[slot >> 3] >> (slot & 7)) & 1)[None]).any(axis=1)
    assert np.array_equal(found.numpy(), undec & hit)
    surv = (undec & ~hit).any(axis=0) & has_more
    idx = np.flatnonzero(surv)
    assert int(nsur) == idx.size
    exp0, exp1 = np.full(C, -7, np.int32), np.full(C, -9, np.int32)
    exp0[:idx.size], exp1[:idx.size] = pay0[idx], pay1[idx]
    assert np.array_equal(p0.numpy(), exp0)
    assert np.array_equal(p1.numpy(), exp1)


@pytest.mark.parametrize("K,masked,expand", [
    (5, False, False), (5, True, False), (5, False, True), (3, True, True),
    (40, False, False)])
def test_exhaust_matches_jax(K, masked, expand):
    """One straggler sweep, the port's _batched_exhaust (words, the plain
    batched_exhaust) against the JAX package's (job-major bitmaps, XLA):
    the same dist, with more listed pairs than live ones (p_total < P)."""
    rng = np.random.default_rng(7 * K + 2 * masked + expand)
    snap = _graph()
    n, level = snap.n, 2
    gj = H.build_chunked_csr(snap)
    gp = P.build_chunked_csr(snap, "cpu")
    degc = gp["degc"].numpy()
    dist = _dist(rng, K, n, level, expand)
    active = rng.random(K) < 0.85
    active[0] = True
    nz = np.flatnonzero(degc[:n] > 0)
    cand_v = np.sort(rng.choice(nz, size=70, replace=False))
    c_count, c_cap = cand_v.size, 128
    cand = np.full(c_cap, n + 1, np.int32)
    cand[:c_count] = cand_v
    off = np.zeros(c_cap, np.int32)
    off[:c_count] = rng.integers(0, degc[cand_v])
    rem8 = int((degc[cand_v] - off[:c_count]).sum())
    p_cap = 2 * next_pow2(max(rem8, 2))        # listed pairs past p_total
    q = gp["q_total"]
    tb = rng.integers(0, 256, q).astype(np.uint8)
    tb[-1] = 0                                 # the all-pad sink column

    got = torch.from_numpy(dist.copy())
    fbits = P._pack_bits_batched(got, torch.from_numpy(active), level, n)
    P._batched_exhaust(got, fbits, torch.from_numpy(cand),
                       torch.from_numpy(off), c_count, level, gp,
                       torch.from_numpy(tb) if masked else None, p_cap,
                       expand)
    dj = jnp.asarray(dist[:, :n + 1])
    ref = H._batched_exhaust()(
        dj, H._pack_bits_batched(dj, jnp.asarray(active), level, n),
        jnp.asarray(cand), jnp.asarray(off),
        jnp.asarray([c_count, rem8], jnp.int32), level, gj["dstT"],
        gj["colstart"], gj["degc"],
        jnp.asarray(tb) if masked else jnp.zeros((1,), jnp.uint8),
        c_cap=c_cap, p_cap=p_cap, n_=n, masked=masked, expand=expand)
    ref = np.asarray(ref)
    assert np.array_equal(got.numpy()[:, :n + 1], ref)
    assert not np.array_equal(ref, dist[:, :n + 1])     # the sweep found


def test_exhaust_skips_dead_pairs_and_drops_stray_owners():
    """Pairs at or past p_total, listed as enumerate_chunk_pairs lists
    them (the all-pad sink column), add nothing, whatever their owner;
    live pairs whose owner lies outside [0, c_cap) are dropped."""
    rng = np.random.default_rng(5)
    K, C, Q, nv, P_ = 16, 20, 64, 200, 100
    rows = np.full((K, (nv + 9) // 8), 255, np.uint8)
    rows[:, (nv + 1) >> 3] &= ~np.uint8(1 << ((nv + 1) & 7))  # pad: no bit
    fbits = cs.rows_to_words(torch.from_numpy(rows), K)
    dstT = torch.from_numpy(rng.integers(0, nv, (8, Q)).astype(np.int32))
    dstT[:, Q - 1] = nv + 1
    owner = torch.from_numpy(np.sort(rng.integers(0, C, P_))
                             .astype(np.int32))
    owner[5], owner[6] = C + 3, -1
    for p_total in (0, 1, 37, P_):
        cols = torch.from_numpy(rng.integers(0, Q - 1, P_).astype(np.int32))
        cols[p_total:] = Q - 1
        found = F.batched_exhaust(cols, owner, torch.tensor(
            p_total, dtype=torch.int32), fbits, None, dstT, K=K, c_cap=C)
        live = set(owner[:p_total].tolist()) - {C + 3, -1}
        exp = torch.zeros((K, C), dtype=torch.bool)
        exp[:, sorted(live)] = True
        assert torch.equal(found, exp)


@pytest.mark.parametrize("seed", [0, 1])
def test_hops_live_jobs_equal_the_job_major_form(seed):
    """In hops mode the rounds' live jobs are the plan's nonzero frontier
    counts; they equal the nonzero rows of the job-major bitmaps the
    port used before words (column n is never == level)."""
    rng = np.random.default_rng(seed)
    snap = _graph()
    n, K, level = snap.n, 9, 2
    gp = P.build_chunked_csr(snap, "cpu")
    dist = _dist(rng, K, n, level, True)
    dist[3, :n] = level + 1                    # a job with no frontier
    active = rng.random(K) < 0.7
    active[0] = True
    _, _, stats = P._batched_plan(torch.from_numpy(dist),
                                  torch.from_numpy(active), level,
                                  gp["degc"], next_pow2(n), n, True)
    rows = np.asarray(H._pack_bits_batched(jnp.asarray(dist[:, :n + 1]),
                                           jnp.asarray(active), level, n))
    assert np.array_equal((stats[1:] > 0).numpy(), (rows != 0).any(axis=1))
    assert not (stats[1:] > 0).all()


def test_non_cpu_tensors_take_the_exhaust_kernel_or_raise():
    """Tensors off the CPU never reach the plain sweep: the wrapper
    routes them to the kernel path, which takes CUDA tensors only."""
    meta = {"cols": torch.zeros(8, dtype=torch.int32, device="meta"),
            "owner": torch.zeros(8, dtype=torch.int32, device="meta"),
            "p_total": torch.zeros((), dtype=torch.int32, device="meta"),
            "fbits": torch.zeros((1, 4), dtype=torch.uint8, device="meta"),
            "dstT": torch.zeros((8, 5), dtype=torch.int32, device="meta")}
    with pytest.raises(ValueError, match="CUDA"):
        F.batched_exhaust(meta["cols"], meta["owner"], meta["p_total"],
                          meta["fbits"], None, meta["dstT"], K=3, c_cap=4)
    assert F.batched_exhaust.launches == 0
