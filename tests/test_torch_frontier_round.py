"""The port's frontier_round (titan_tpu_torch.ops.frontier) on the CPU.

The JAX package's Pallas kernel cannot serve as the oracle here: its
interpreter path fails under the installed jax (``pl.store`` is gone).
So the plain version is held against the numpy oracle of
tests/test_pallas_frontier.py, which states the kernel contract on
job-major bitmaps; the round takes the same bits as vertex-major words
(``chip_smoke.rows_to_words``, plain torch, independent of the
package's packer). The CUDA kernel is held against the plain version on
the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import chip_smoke as cs

import titan_tpu.models.bfs_hybrid as H
import titan_tpu_torch.models.bfs_hybrid as PH
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu.ops.pallas_frontier import \
    ladder_fetch_counts as jax_ladder_fetch_counts
from titan_tpu_torch import build
from titan_tpu_torch.ops import frontier as F


def _inputs(seed, K, C, Q, n_val, masked):
    rng = np.random.default_rng(seed)
    return dict(
        dstT=rng.integers(0, n_val + 1, (8, Q)).astype(np.int32),
        cols=rng.integers(0, Q, C).astype(np.int32),
        undec=rng.random((K, C)) < 0.7,
        has_more=rng.random(C) < 0.6,
        pay0=rng.integers(0, n_val, C).astype(np.int32),
        pay1=rng.integers(0, 8, C).astype(np.int32),
        fbits=rng.integers(0, 256, (K, (n_val + 9) // 8)).astype(np.uint8),
        tbits=rng.integers(0, 256, Q).astype(np.uint8) if masked else None)


def _run(fn, a, lanes, fill0, fill1):
    """The round on ``a``, its job-major bitmaps given as words."""
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    t["fbits"] = cs.rows_to_words(t["fbits"], t["undec"].shape[0])
    return fn(t["cols"], t["undec"], t["has_more"], t["pay0"], t["pay1"],
              t["fbits"], t["tbits"], t["dstT"], lanes=lanes, fill0=fill0,
              fill1=fill1)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("lanes", [2, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_reference_matches_numpy_oracle(K, lanes, masked):
    """found equals the flat 8-lane masked bitmap test for every
    undecided (job, candidate) pair; survivors compact in stable order
    with the fills; nsur is exact (the oracle of
    tests/test_pallas_frontier.py)."""
    C = 70
    a = _inputs(3, K, C, 51, 160, masked)
    found, p0, p1, nsur = _run(F.frontier_round, a, lanes, -7, -9)

    dstT, cols, undec, fbits, tbits = (a["dstT"], a["cols"], a["undec"],
                                       a["fbits"], a["tbits"])
    par = dstT[:, cols]                                   # (8, C)
    hit = (fbits[:, par >> 3] >> (par & 7)[None]) & 1     # (K, 8, C)
    if masked:
        slot = cols[None, :] * 8 + np.arange(8)[:, None]
        hit = hit & ~((tbits[slot >> 3] >> (slot & 7)) & 1)[None]
    hit = hit.any(axis=1)                                 # (K, C)
    assert found.dtype == torch.bool
    assert np.array_equal(found.numpy(), undec & hit)

    surv = (undec & ~hit).any(axis=0) & a["has_more"]
    idx = np.flatnonzero(surv)
    assert nsur.dtype == torch.int32 and int(nsur) == idx.size
    exp0 = np.full(C, -7, np.int32)
    exp1 = np.full(C, -9, np.int32)
    exp0[:idx.size] = a["pay0"][idx]
    exp1[:idx.size] = a["pay1"][idx]
    assert np.array_equal(p0.numpy(), exp0)
    assert np.array_equal(p1.numpy(), exp1)


@pytest.mark.parametrize("masked", [False, True])
def test_ladder_never_changes_found_set(masked):
    """The narrow-first ladder (lanes=2) and the flat 8-lane fetch
    (lanes=8) give identical outputs."""
    a = _inputs(11, 2, 40, 33, 120, masked)
    a["pay0"] = np.arange(40, dtype=np.int32)
    outs = [_run(F.frontier_round_reference, a, w, 0, 0) for w in (2, 8)]
    for x, y in zip(*outs):
        assert torch.equal(x, y)


def _hub_graph():
    """tests/test_lane_economics.py's hub graph: 47 children of hub 0
    decide in lane 0, a hub-free ring of 8 misses every narrow lane."""
    n, ring = 64, range(48, 56)
    src = [0] * 47 + list(ring)
    dst = list(range(1, 48)) + [v + 1 if v + 1 in ring else ring.start
                                for v in ring]
    src, dst = np.asarray(src), np.asarray(dst)
    return n, snap_mod.from_arrays(n, np.concatenate([src, dst]),
                                   np.concatenate([dst, src]))


@pytest.mark.parametrize("masked", [False, True])
def test_ladder_fetch_counts_match_jax(masked):
    n, snap = _hub_graph()
    g = H.build_chunked_csr(snap)
    host = g["_host"]
    dist = np.full(n + 2, PH.INF, np.int32)
    dist[0] = 0
    fbits = PH._pack_bits(torch.from_numpy(dist), 0, n).numpy()
    cand = np.flatnonzero((dist[:n] >= PH.INF) & (host["degc"][:n] > 0))
    cols = host["colstart"][cand]
    tbits = (np.random.default_rng(1).integers(0, 256, g["q_total"])
             .astype(np.uint8) if masked else None)
    got = F.ladder_fetch_counts(cols, fbits, host["dstT"], 2, tbits)
    assert got == jax_ladder_fetch_counts(cols, fbits, host["dstT"], 2,
                                          tbits)
    if not masked:
        narrow_b, wide_b, base_b = got
        assert narrow_b + wide_b < base_b
        assert wide_b == 8 * 4 * 8            # the 8 ring vertices


def test_non_cpu_tensors_take_the_kernel_path_or_raise():
    """Tensors off the CPU never reach the plain version: the wrapper
    routes them to the kernel path, which takes CUDA tensors only."""
    a = _inputs(0, 1, 16, 9, 40, False)
    meta = {k: None if v is None else torch.from_numpy(v).to("meta")
            for k, v in a.items()}
    with pytest.raises(ValueError, match="CUDA"):
        F.frontier_round(meta["cols"], meta["undec"], meta["has_more"],
                         meta["pay0"], meta["pay1"], meta["fbits"], None,
                         meta["dstT"], lanes=2, fill0=0, fill1=0)
    assert F.frontier_round.launches == 0


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def _hit_any_whole(fbits, tbits, par, pcols):
    """The plain round's former test on job-major bitmaps: one
    [K, l, C] int32 array."""
    nb = fbits.shape[1]
    byte = (par >> 3).clamp(0, nb - 1).long()
    w = fbits[:, byte].to(torch.int32)                   # (K, l, C)
    h = ((w >> (par & 7)) & 1) > 0
    if tbits is not None:
        lane = torch.arange(par.shape[0])[:, None]
        slot = pcols[None, :] * 8 + lane
        tw = tbits[(slot >> 3).clamp(0, tbits.shape[0] - 1)].to(torch.int32)
        h = h & ~(((tw >> (slot & 7).to(torch.int32)) & 1) > 0)[None]
    return h.any(dim=1)


def _round_bytes_whole(a, lanes):
    """chip_smoke.round_bytes in a whole form ([K, l, C] temporaries and
    every frontier offset listed, under both layouts), on job-major
    bitmaps."""
    import chip_smoke as cs
    dstT, fb, tb, undec = a["dstT"], a["fbits"], a["tbits"], a["undec"]
    K, C = undec.shape
    Q, nb = dstT.shape[1], fb.shape[1]
    plane = nb * 32                               # K = 40: Kp = 32
    col = a["cols"].long().clamp(0, Q - 1)
    j = torch.arange(C)
    live = undec.any(0)
    lane = torch.arange(8)[:, None]
    if tb is None:
        open_ = torch.ones((8, C), dtype=torch.bool)
    else:
        w = tb[col.clamp(max=tb.numel() - 1)].int()
        open_ = ((w[None] >> lane) & 1) == 0
    fb_offsets, word_offsets = [], []

    def test(l0, l1, want):
        par = dstT[l0:l1][:, col]
        byte = (par >> 3).long().clamp(0, nb - 1)
        tested = want[:, None, :] & open_[l0:l1][None]
        kk = torch.arange(K)[:, None, None]
        fb_offsets.append((kk * nb + byte[None]).expand_as(tested)[tested])
        word = par.long().clamp(0, plane // 4 - 1) * 4
        word_offsets.append(((kk // 32) * plane + word[None])
                            .expand_as(tested)[tested])
        bit = (fb[:, byte].int() >> (par & 7)[None]) & 1
        return (tested & (bit > 0)).any(1)

    hit = test(0, lanes, undec)
    missed = undec & ~hit
    wide = missed.any(0) if lanes < 8 else torch.zeros_like(live)
    if lanes < 8:
        missed = missed & ~test(lanes, 8, missed)
    out_miss = missed.any(0)
    surv = out_miss & a["has_more"]
    sb = cs.sector_bytes
    dstT_8q = sum(sb(l * Q + col[live if l < lanes else wide], 4)
                  for l in range(8))
    dstT_q8 = sb(col[live], 32)
    fbits_rows = sb(torch.cat(fb_offsets), 1)
    fbits_words = sb(torch.cat(word_offsets), 1)
    rest = (sb(j[live], 4) + K * C
            + (0 if tb is None else sb(col[live], 1))
            + sb(j[out_miss], 1) + 2 * sb(j[surv], 4) + K * C + 8 * C + 4)
    d_min, f_min = min(dstT_8q, dstT_q8), min(fbits_rows, fbits_words)
    return {"bytes": rest + d_min + f_min,
            "bytes_8q": rest + dstT_8q + f_min,
            "bytes_q8": rest + dstT_q8 + f_min,
            "bytes_rows": rest + d_min + fbits_rows,
            "bytes_words": rest + d_min + fbits_words,
            "dstT_8q": dstT_8q, "dstT_q8": dstT_q8,
            "fbits_rows": fbits_rows, "fbits_words": fbits_words,
            "live": int(live.sum()), "nsur": int(surv.sum())}


@pytest.mark.parametrize("lanes", [2, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_job_by_job_forms_equal_the_whole_forms_at_k40(lanes, masked):
    """At K = 40 (two of the kernel's job groups, two planes of words)
    the plain round's plane-by-plane word test equals the former
    [K, l, C] form on job-major bitmaps, so the plain round's outputs do
    not change, and chip_smoke.round_bytes, which marks the frontier
    sectors job by job and plane by plane, counts what its whole form
    counts, given the bits in either layout."""
    a = _inputs(5, 40, 300, 97, 700, masked)
    a["fbits"][:, 3::5] = 0                  # some sectors no test touches
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    words = cs.rows_to_words(t["fbits"], 40)
    c = t["cols"].long().clamp(0, 96)
    for l1 in (lanes, 8):                    # the narrow test, the refetch
        par = t["dstT"][:l1][:, c]
        assert torch.equal(
            F.job_bits(F._hit_words(words, t["tbits"], par, c, 32), 40),
            _hit_any_whole(t["fbits"], t["tbits"], par, c))
    assert cs.round_bytes(t, lanes) == _round_bytes_whole(t, lanes)
    assert cs.round_bytes({**t, "fbits": words}, lanes) \
        == _round_bytes_whole(t, lanes)
    found, _, _, nsur = _run(F.frontier_round, a, lanes, -7, -9)
    assert found.shape == (40, 300)
    assert cs.round_bytes(t, lanes)["nsur"] == int(nsur)
