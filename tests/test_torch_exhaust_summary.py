"""The batched sweep's frontier summary (``ops.frontier.summary_shape``,
``exhaust_summary_reference``; ``csrc/batched_exhaust.cu`` builds it on
the card and holds it in shared memory) against a numpy OR over the
words ``words_at`` reads, and a numpy model of the sweep that loads a
parent's word only where the summary's bit is set against the plain
sweep (``batched_exhaust_reference``): the summary must only ever skip
words that are zero, parents at and past n and below 0 included (the
kernel keys a parent on the byte ``word_of`` would load, its clamps
included)."""

import numpy as np
import pytest
import torch

from titan_tpu_torch.ops import frontier as F

KS = (1, 3, 8, 16, 32, 40)


def _words(rng, K, nv, density, skip=()):
    """``([G, nb] uint8, slots)``: the words of K random frontiers over
    ``nv`` vertices, none holding a vertex of ``skip``, set bit by bit
    into the vertex-major layout (the package's packer is not used)."""
    Kp, G = F.word_bits(K)
    nb = F.plane_bytes(nv, K)
    slots = nb * 8 // Kp
    out = np.zeros((G, nb * 8), np.uint8)
    for k in range(K):
        on = rng.random(slots) < density
        on[list(skip)] = False
        out[k // 32, np.flatnonzero(on) * Kp + k % 32] = 1
    return torch.from_numpy(np.packbits(out, axis=1,
                                        bitorder="little")), slots


def _word_byte(nb, Kp, par):
    """numpy: the byte at which the kernel's word load for ``par`` starts,
    with its clamps (``frontier_words.cuh``'s ``word_byte``)."""
    par = np.asarray(par, np.int64)
    if Kp >= 8:
        wb = Kp // 8
        return np.clip(par, 0, nb // wb - 1) * wb
    return np.clip((par * Kp) >> 3, 0, nb - 1)


def _bits(summary):
    return ((summary.numpy().astype(np.int64)[:, None]
             >> np.arange(32)) & 1).reshape(-1)


def _words_any(fbits, K, par):
    """numpy OR over the planes of ``words_at`` at ``par``: nonzero where
    some job of some plane holds the parent."""
    Kp, _ = F.word_bits(K)
    p = torch.from_numpy(np.asarray(par, np.int32))
    return np.any([F.words_at(pl, p, Kp).numpy() != 0 for pl in fbits],
                  axis=0)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("density", [0.0, 0.002, 0.3])
def test_summary_is_the_or_of_words_at(K, density):
    rng = np.random.default_rng(K * 1000 + int(density * 1e4))
    nv = 5000 + K
    fbits, slots = _words(rng, K, nv, density)
    Kp, _ = F.word_bits(K)
    nb = fbits.shape[1]
    sh, nsw = F.summary_shape(nb, K)
    got = _bits(F.exhaust_summary_reference(fbits, K))
    assert got.shape == (nsw * 32,)
    # every vertex slot of the plane, then parents at and past n, past
    # the plane and below 0, which the kernel clamps
    par = np.concatenate([np.arange(slots), [nv, nv + 1, slots, slots + 7,
                                             2**31 - 1, -1, -2**31]])
    hit = _words_any(fbits, K, par)
    block = _word_byte(nb, Kp, par) >> sh
    want = np.zeros(nsw * 32, np.int64)
    np.maximum.at(want, block[hit], 1)
    assert np.array_equal(got, want)
    # a parent whose word is nonzero always finds its bit set
    assert got[block[hit]].all()


@pytest.mark.parametrize("K", KS)
def test_shape_bounds_the_summary(K):
    Kp, _ = F.word_bits(K)
    for nv in (1, 77, 1 << 12, 1 << 20, (1 << 26) + 2):
        nb = F.plane_bytes(nv, K)
        sh, nsw = F.summary_shape(nb, K)
        assert (1 << sh) >= max(Kp // 8, 1)       # a word inside one bit
        assert (nsw * 32) << sh >= nb            # the plane covered
        assert nsw * 32 <= F.SUMMARY_BITS + 31   # the shared-memory cap
        assert sh == (max(Kp // 8, 1)).bit_length() - 1 or \
            (nb + (1 << (sh - 1)) - 1) >> (sh - 1) > F.SUMMARY_BITS


def _sweep_through_summary(cols, owner, p_total, fbits, tbits, dstT, K,
                           c_cap):
    """numpy model of the kernel's sweep: a live pair's open parents are
    tested against the summary first, and only a set bit loads a word."""
    Kp, G = F.word_bits(K)
    nb = fbits.shape[1]
    sh, _ = F.summary_shape(nb, K)
    summ = _bits(F.exhaust_summary_reference(fbits, K))
    live = min(max(int(p_total), 0), len(cols))
    col = np.clip(cols[:live].astype(np.int64), 0, dstT.shape[1] - 1)
    par = dstT[:, col]                                      # [8, live]
    lane = np.arange(8)[:, None]
    open_ = np.ones_like(par, bool) if tbits is None else \
        ((tbits[np.clip(col, 0, len(tbits) - 1)][None] >> lane) & 1) == 0
    load = open_ & (summ[_word_byte(nb, Kp, par) >> sh] == 1)
    out = np.zeros((G, c_cap), np.int64)
    own = owner[:live].astype(np.int64)
    ok = (own >= 0) & (own < c_cap)
    for g in range(G):
        w = F.words_at(fbits[g], torch.from_numpy(par.astype(np.int32)),
                       Kp).numpy().astype(np.int64) & 0xFFFFFFFF
        any_ = np.bitwise_or.reduce(np.where(load, w, 0), axis=0)
        np.bitwise_or.at(out[g], own[ok], any_[ok])
    return np.stack([(out[k // 32] >> (k % 32)) & 1 for k in range(K)]) > 0


@pytest.mark.parametrize("K", [1, 3, 16, 32, 40])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("density", [0.001, 0.5])
def test_sweep_through_the_summary_is_the_plain_sweep(K, masked, density):
    rng = np.random.default_rng(7 * K + masked + int(density * 1000))
    nv, Q, P, c_cap = 3000, 2000, 6000, 500
    # the pad vertex nv + 1, every dead pair's parent, holds no job
    fbits, slots = _words(rng, K, nv + 2, density, skip=(nv + 1,))
    dstT = rng.integers(-40, slots + 40, (8, Q)).astype(np.int32)
    dstT[:, Q - 1] = nv + 1
    dstT[0, :50] = np.array([nv, nv + 1, slots - 1, slots, 2**31 - 1,
                             -2**31, 0, -1, 1, 2] * 5, np.int32)
    cols = rng.integers(-5, Q + 5, P).astype(np.int32)
    p_total = P - 37
    cols[p_total:] = Q - 1
    owner = np.sort(rng.integers(-3, c_cap + 3, P)).astype(np.int32)
    tbits = rng.integers(0, 256, Q).astype(np.uint8) if masked else None
    want = F.batched_exhaust_reference(
        torch.from_numpy(cols), torch.from_numpy(owner),
        torch.tensor(p_total, dtype=torch.int32), fbits,
        None if tbits is None else torch.from_numpy(tbits),
        torch.from_numpy(dstT), K=K, c_cap=c_cap).numpy()
    got = _sweep_through_summary(cols, owner, p_total, fbits, tbits, dstT,
                                 K, c_cap)
    assert np.array_equal(got, want)
    if density > 0.1:
        assert got.any()


def test_summary_kernel_takes_cuda_tensors_only():
    """The summary is a step of the card's sweep: the CPU sweep takes the
    plain version and launches no summary, and the summary's launcher
    refuses CPU tensors."""
    rng = np.random.default_rng(3)
    fbits, _ = _words(rng, 16, 1000, 0.01)
    before = F._launch_summary.launches
    cols = torch.zeros(4, dtype=torch.int32)
    dstT = torch.zeros((8, 2), dtype=torch.int32)
    F.batched_exhaust(cols, cols, torch.tensor(4, dtype=torch.int32), fbits,
                      None, dstT, K=16, c_cap=2)
    assert F._launch_summary.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        F._launch_summary(fbits, 16)
