"""The one-pass compaction of the frontier_round kernel
(titan_tpu_torch/csrc/frontier_round.cu), modelled in numpy on the CPU,
and the plain version on the opener's rising columns.

The kernel ranks survivors without a second launch. Each tile of T
candidates publishes its survivor count; tile 0 publishes it as a
prefix. A tile is finished later by decoupled look-back: one warp walks
back over windows of 32 statuses until a window holds a prefix with
every tile after it published, and adds the counts. The tile then
publishes its own prefix and writes its slots: a survivor with s
survivors before it writes its payloads to slot s, a non-survivor at
index j writes the fills to slot C - 1 - (j - s). The model runs the
publishes and the finishes in random orders (a finish goes only when its
walk would end, as the kernel's warp spins until it does) and checks
that every slot is written once and that the result is
``scatter_compact``'s stable order and count.

The second test holds ``frontier_round_reference`` to the numpy oracle
of tests/test_torch_frontier_round.py on inputs shaped as the bottom-up
opener makes them: the unvisited vertices of a real chunked CSR in
vertex order, so the columns rise and lie close together, followed by
dead slots. The oracle reads job-major bitmaps; the round gets the same
bits as words (``chip_smoke.rows_to_words``).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs

import titan_tpu.models.bfs_hybrid as H
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu.ops.compaction import scatter_compact as jax_scatter_compact
from titan_tpu_torch.ops import frontier as F
from titan_tpu_torch.ops.compaction import scatter_compact

INVALID, AGGREGATE, PREFIX = 0, 1, 2


def _look_back(state, value, tile):
    """The kernel's walk for ``tile`` > 0: the survivors before it, or
    None where its warp would read the window again."""
    acc, end = 0, tile
    while True:
        idx = np.arange(end - 32, end)
        s = np.where(idx >= 0, state[np.maximum(idx, 0)], PREFIX)
        v = np.where(idx >= 0, value[np.maximum(idx, 0)], 0)
        pre = np.flatnonzero(s == PREFIX)
        inv = np.flatnonzero(s == INVALID)
        p = pre[-1] if pre.size else -1
        if p > (inv[-1] if inv.size else -1):
            return acc + int(v[p:].sum())
        if inv.size:
            return None
        acc += int(v.sum())
        end -= 32


def _one_pass(surv, pay0, pay1, t, fill0, fill1, rng):
    c = surv.shape[0]
    ntiles = -(-c // t)
    counts = np.add.reduceat(surv.astype(np.int64), np.arange(ntiles) * t)
    state = np.zeros(ntiles, np.int64)
    value = np.zeros(ntiles, np.int64)
    out0 = np.full(c, 12345, np.int32)
    out1 = np.full(c, 12345, np.int32)
    writes = np.zeros(c, np.int64)
    nsur = None
    # each tile is published, then finished, and tiles are handed out in
    # ticket order to a few blocks that run at random speeds
    pending = [("publish", k) for k in range(ntiles)]
    published = set()
    while pending:
        ready = [i for i, (kind, k) in enumerate(pending)
                 if kind == "publish" or k in published]
        i = ready[int(rng.integers(len(ready)))]
        kind, k = pending[i]
        if kind == "publish":
            state[k] = PREFIX if k == 0 else AGGREGATE
            value[k] = counts[k]
            published.add(k)
            pending[i] = ("finish", k)
            continue
        before = 0 if k == 0 else _look_back(state, value, k)
        if before is None:
            continue                         # the warp spins; others run
        pending.pop(i)
        state[k], value[k] = PREFIX, before + counts[k]
        if k == ntiles - 1:
            nsur = before + counts[k]
        j = np.arange(k * t, min((k + 1) * t, c))
        s = surv[j]
        rank = before + np.cumsum(s) - s        # survivors before j
        out0[rank[s]] = pay0[j[s]]
        out1[rank[s]] = pay1[j[s]]
        slot = c - 1 - (j[~s] - rank[~s])
        out0[slot] = fill0
        out1[slot] = fill1
        np.add.at(writes, np.concatenate([rank[s], slot]), 1)
    assert np.all(writes == 1), "a slot was written twice or never"
    return nsur, out0, out1


SURVIVORS = ("none", "all", "sparse", "dense", "runs")


def _surv(kind, c, rng):
    if kind == "none":
        return np.zeros(c, bool)
    if kind == "all":
        return np.ones(c, bool)
    if kind == "runs":                      # long runs, tiles all or nothing
        return (np.cumsum(rng.random(c) < 0.01) % 2).astype(bool)
    return rng.random(c) < (0.05 if kind == "sparse" else 0.7)


@pytest.mark.parametrize("kind", SURVIVORS)
@pytest.mark.parametrize("c,t", [(1, 8), (9, 8), (1000, 8), (3001, 4),
                                 (5000, 64)])
def test_one_pass_compaction_is_scatter_compact(c, t, kind):
    seed = 7 * c + t + SURVIVORS.index(kind)
    rng = np.random.default_rng(seed)
    surv = _surv(kind, c, rng)
    pay0 = rng.integers(0, 1 << 30, c).astype(np.int32)
    pay1 = rng.integers(0, 8, c).astype(np.int32)
    nsur, out0, out1 = _one_pass(surv, pay0, pay1, t, -7, -9, rng)
    exp_n, (exp0, exp1) = scatter_compact(
        torch.from_numpy(surv), (torch.from_numpy(pay0),
                                 torch.from_numpy(pay1)), c, (-7, -9))
    assert nsur == int(exp_n)
    np.testing.assert_array_equal(out0, exp0.numpy())
    np.testing.assert_array_equal(out1, exp1.numpy())
    jax_n, (jax0, _) = jax_scatter_compact(surv, (pay0, pay1), c, (-7, -9))
    assert nsur == int(jax_n)
    np.testing.assert_array_equal(out0, np.asarray(jax0))


def _opener_inputs(seed, K, masked):
    """Round inputs as ``_bu_open`` makes them on an R-MAT chunked CSR."""
    rng = np.random.default_rng(seed)
    n, m = 512, 6000
    src = rng.integers(0, n, m) % (rng.integers(1, n, m) + 1)   # skewed
    dst = rng.integers(0, n, m)
    snap = snap_mod.from_arrays(n, np.concatenate([src, dst]),
                                np.concatenate([dst, src]))
    host = H.build_chunked_csr(snap)["_host"]
    dstT, colstart, degc = host["dstT"], host["colstart"], host["degc"]
    q_pad = dstT.shape[1] - 1
    unvis = (rng.random(n) < 0.6) & (degc[:n] > 0)
    cand = np.flatnonzero(unvis)
    c = 1 << int(np.ceil(np.log2(max(n, 2))))
    v = np.full(c, n, np.int64)
    v[:cand.size] = cand
    alive = np.arange(c) < cand.size
    undec = np.repeat(alive[None], K, axis=0)
    if K > 1:
        undec &= rng.random((K, c)) < 0.8
    nb = (n + 2 + 7) // 8
    return dict(
        dstT=np.ascontiguousarray(dstT).astype(np.int32),
        cols=np.where(alive, colstart[np.minimum(v, n)], q_pad)
        .astype(np.int32),
        undec=undec, has_more=alive & (degc[np.minimum(v, n)] > 1),
        pay0=v.astype(np.int32), pay1=np.ones(c, np.int32),
        fbits=rng.integers(0, 256, (K, nb)).astype(np.uint8)
        & rng.integers(0, 256, (K, nb)).astype(np.uint8),
        tbits=(rng.integers(0, 256, dstT.shape[1]).astype(np.uint8)
               if masked else None))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("lanes", [2, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_reference_matches_numpy_oracle_on_rising_columns(K, lanes, masked):
    a = _opener_inputs(11 + K + lanes, K, masked)
    cols = a["cols"]
    live = a["undec"].any(axis=0)
    assert np.all(np.diff(cols[live].astype(np.int64)) > 0)    # rising
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    t["fbits"] = cs.rows_to_words(t["fbits"], K)       # the round's words
    found, p0, p1, nsur = F.frontier_round(
        t["cols"], t["undec"], t["has_more"], t["pay0"], t["pay1"],
        t["fbits"], t["tbits"], t["dstT"], lanes=lanes, fill0=-7, fill1=-9)

    dstT, undec, fbits, tbits = a["dstT"], a["undec"], a["fbits"], a["tbits"]
    par = dstT[:, cols]                                   # (8, C)
    hit = (fbits[:, par >> 3] >> (par & 7)[None]) & 1     # (K, 8, C)
    if masked:
        slot = cols[None, :].astype(np.int64) * 8 + np.arange(8)[:, None]
        hit = hit & ~((tbits[slot >> 3] >> (slot & 7)) & 1)[None]
    hit = hit.any(axis=1)                                 # (K, C)
    np.testing.assert_array_equal(found.numpy(), undec & hit)
    surv = (undec & ~hit).any(axis=0) & a["has_more"]
    idx = np.flatnonzero(surv)
    assert int(nsur) == idx.size
    exp0 = np.full(cols.size, -7, np.int32)
    exp1 = np.full(cols.size, -9, np.int32)
    exp0[:idx.size] = a["pay0"][idx]
    exp1[:idx.size] = a["pay1"][idx]
    np.testing.assert_array_equal(p0.numpy(), exp0)
    np.testing.assert_array_equal(p1.numpy(), exp1)
