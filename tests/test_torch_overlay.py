"""The port's live overlay (titan_tpu_torch.olap.live.overlay) against
the JAX package's, on the CPU: after the same appends and removals the
views are bit-equal, and so are the counts, ``stats()``, the upload byte
counter and the ledger's reservations. The snapshot's ``out_csr`` equals
the JAX snapshot's and its slot ids agree with ``build_chunked_csr``'s
layout. The batched BFS over (base, overlay) equals the batched BFS over
a rebuilt snapshot and the JAX package's over its own overlay, and a view
kept across later mutations still gives its old answer."""

import numpy as np
import pytest
import torch

import titan_tpu.models.bfs_hybrid as H
import titan_tpu_torch.models.bfs_hybrid as P
from titan_tpu.olap.live.overlay import DeltaOverlay as JaxOverlay
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu.olap.tpu.rmat import rmat_edges
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.live import DeltaOverlay, OverlayView

N, M, SEED = 192, 900, 42
CAP = 256


class _Counter:
    def __init__(self):
        self.value = 0

    def inc(self, k):
        self.value += k


class _Metrics:
    def __init__(self):
        self.counters = {}

    def counter(self, name):
        return self.counters.setdefault(name, _Counter())


class _Ledger:
    def __init__(self):
        self.log = []

    def reserve(self, key, nbytes):
        self.log.append(("reserve", nbytes))

    def release(self, key):
        self.log.append(("release",))


def _base(rng, labels=False):
    src = rng.integers(0, N, M).astype(np.int32)
    dst = rng.integers(0, N, M).astype(np.int32)
    lab = rng.integers(0, 3, 2 * M).astype(np.int32) if labels else None
    js = JS.from_arrays(N, np.concatenate([src, dst]),
                        np.concatenate([dst, src]), labels=lab)
    return src, dst, js, PS.from_numpy(js)


def _pair(js, ps):
    mj, mp, lj, lp = _Metrics(), _Metrics(), _Ledger(), _Ledger()
    oj = JaxOverlay(js, min_cap=CAP, metrics=mj, ledger=lj, ledger_key="k")
    op = DeltaOverlay(ps, min_cap=CAP, metrics=mp, ledger=lp,
                      ledger_key="k", device="cpu")
    return (oj, mj, lj), (op, mp, lp)


def _same_views(vj, vp):
    assert isinstance(vp, OverlayView)
    for f in ("n", "cap", "count", "tomb_count", "seq", "slot_base"):
        assert getattr(vj, f) == getattr(vp, f), f
    for f in ("src_dev", "dst_dev", "tomb_dev"):
        a, b = np.asarray(getattr(vj, f)), getattr(vp, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert vj.empty == vp.empty and vj.has_tombstones == vp.has_tombstones


def _uploaded(metrics):
    c = metrics.counters.get("serving.live.upload_bytes")
    return None if c is None else c.value


def _same_state(j, p):
    (oj, mj, lj), (op, mp, lp) = j, p
    assert oj.stats() == op.stats()
    assert (oj.count, oj.tomb_count, oj.dead_adds, oj.seq, oj.cap) == \
        (op.count, op.tomb_count, op.dead_adds, op.seq, op.cap)
    assert oj.fill_fraction() == op.fill_fraction()
    assert oj.tombstone_fraction() == op.tombstone_fraction()
    assert oj.device_bytes() == op.device_bytes()
    assert np.array_equal(oj.tomb_row_mask, op.tomb_row_mask)
    for a, b in zip(oj.live_adds(), op.live_adds()):
        assert np.array_equal(a, b)
    assert _uploaded(mj) == _uploaded(mp)
    assert lj.log == lp.log


def _mutate(rng, src, dst, both, n_add, n_rm, labels=None, odd=True):
    a_s = rng.integers(0, N, n_add).astype(np.int32)
    a_d = rng.integers(0, N, n_add).astype(np.int32)
    lab = np.zeros(2 * n_add, np.int32) if labels is None else \
        rng.integers(0, 3, 2 * n_add).astype(np.int32)
    rm = rng.choice(M, n_rm, replace=False)
    out = []
    for ov, _, _ in both:
        ov.append_edges(np.concatenate([a_s, a_d]),
                        np.concatenate([a_d, a_s]), lab)
        res = []
        for i in rm:
            res.append(ov.remove_edge(int(src[i]), int(dst[i]), labels))
            res.append(ov.remove_edge(int(dst[i]), int(src[i]), labels))
        if odd:
            # an appended row (or a base row of the same ends), and an
            # edge of a label no row has
            res.append(ov.remove_edge(int(a_s[0]), int(a_d[0]), None))
            res.append(ov.remove_edge(N - 1, N - 1, 7))
        out.append(res)
    assert out[0] == out[1]
    return a_s, a_d, rm


def test_out_csr_matches_jax_and_the_slot_layout():
    """The port's out_csr (and its src-order permutation) equals the JAX
    snapshot's; slot ``colstart[u]*8 + (p - p0)`` holds out-CSR edge p in
    build_chunked_csr's dstT, which is what the tombstones address."""
    for scale in (6, 10):
        s, d = rmat_edges(scale, 8, seed=scale)
        js = JS.from_arrays(1 << scale, np.concatenate([s, d]),
                            np.concatenate([d, s]))
        ps = PS.from_numpy(js)
        dj, ij = js.out_csr()
        dp, ip = ps.out_csr()
        assert dp.dtype == dj.dtype and np.array_equal(dj, dp)
        assert np.array_equal(ij, ip)
        assert np.array_equal(np.asarray(js._out_csr_order),
                              ps._out_csr_order)
        assert ps.out_csr() is ps.out_csr()          # cached
        g = P.build_chunked_csr(ps, device="cpu")
        flat = g["dstT"].numpy().T.reshape(-1)
        colstart = g["colstart"].numpy().astype(np.int64)
        u = np.repeat(np.arange(ps.n), np.diff(ip))
        slot = colstart[u] * 8 + (np.arange(len(dp)) - ip[u])
        assert np.array_equal(flat[slot], dp)


@pytest.mark.parametrize("labels", [False, True])
def test_views_match_jax_after_the_same_mutations(labels):
    """Views, counts, stats, upload bytes and ledger calls equal after
    each of: a fresh overlay, appends and removals, more mutations (rows
    killed below the watermark), and a capacity growth."""
    rng = np.random.default_rng(SEED)
    src, dst, js, ps = _base(rng, labels)
    j, p = _pair(js, ps)
    _same_views(j[0].view(), p[0].view())
    _same_state(j, p)
    lab = 1 if labels else None
    _mutate(rng, src, dst, (j, p), 60, 40, lab)
    _same_views(j[0].view(), p[0].view())
    _same_state(j, p)
    a_s, a_d, _ = _mutate(rng, src, dst, (j, p), 30, 10, lab)
    for ov, _, _ in (j, p):          # kill rows already on the device
        assert ov.remove_edge(int(a_s[1]), int(a_d[1]), None)
    _same_views(j[0].view(), p[0].view())
    _same_state(j, p)
    _mutate(rng, src, dst, (j, p), 200, 5, lab)   # past 256 rows: grows
    assert p[0].cap == j[0].cap > CAP
    _same_views(j[0].view(), p[0].view())
    _same_state(j, p)
    for ov, _, _ in (j, p):
        ov.close()
    assert j[2].log == p[2].log


def test_batched_bfs_over_the_overlay_equals_a_rebuild():
    """As tests/test_live_overlay.py holds the JAX package (there at K = 4,
    here at K = 8): base + overlay equals a snapshot rebuilt from the
    final edge list, and equals the JAX package over its own overlay."""
    rng = np.random.default_rng(SEED)
    src, dst, js, ps = _base(rng)
    j, p = _pair(js, ps)
    a_s, a_d, rm = _mutate(rng, src, dst, (j, p), 60, 40, odd=False)
    vj, vp = j[0].view(), p[0].view()
    keep = np.ones(M, bool)
    keep[rm] = False
    fs = np.concatenate([src[keep], a_s])
    fd = np.concatenate([dst[keep], a_d])
    rebuilt = PS.from_arrays(N, np.concatenate([fs, fd]),
                             np.concatenate([fd, fs]))
    srcs = [int(x) for x in rng.choice(N, 8, replace=False)]
    d_ov, lv_ov, c_ov = P.frontier_bfs_batched(ps, srcs, overlay=vp,
                                               device="cpu")
    d_rb, lv_rb, c_rb = P.frontier_bfs_batched(rebuilt, srcs,
                                               device="cpu")
    assert np.array_equal(d_ov, d_rb)
    assert np.array_equal(lv_ov, lv_rb) and np.array_equal(c_ov, c_rb)
    d_j, lv_j, c_j = H.frontier_bfs_batched(js, srcs, overlay=vj)
    assert np.array_equal(np.asarray(d_j), d_ov)
    assert np.array_equal(lv_j, lv_ov) and np.array_equal(c_j, c_ov)
    # the snapshot's attached overlay is the default
    ps._live_overlay = vp
    d_at, _, _ = P.frontier_bfs_batched(ps, srcs, device="cpu")
    assert np.array_equal(d_at, d_ov)
    # the hops mode reads the overlay too
    hj = H.frontier_bfs_batched(js, srcs, overlay=vj, mode="hops",
                                start_level=1, max_levels=3)
    hp = P.frontier_bfs_batched(ps, srcs, overlay=vp, mode="hops",
                                start_level=1, max_levels=3, device="cpu")
    for a, b in zip(hj, hp):
        assert np.array_equal(np.asarray(a), b)


def test_a_kept_view_keeps_its_answer():
    """Copy-on-write: a view taken before later appends, removals and a
    capacity growth keeps its tensors and its BFS answer."""
    rng = np.random.default_rng(SEED + 1)
    src, dst, js, ps = _base(rng)
    ov = DeltaOverlay(ps, min_cap=CAP, device="cpu")
    a_s = rng.integers(0, N, 40).astype(np.int32)
    a_d = rng.integers(0, N, 40).astype(np.int32)
    ov.append_edges(np.concatenate([a_s, a_d]), np.concatenate([a_d, a_s]),
                    np.zeros(80, np.int32))
    for i in rng.choice(M, 20, replace=False):
        ov.remove_edge(int(src[i]), int(dst[i]), None)
        ov.remove_edge(int(dst[i]), int(src[i]), None)
    old = ov.view()
    frozen = [t.clone() for t in (old.src_dev, old.dst_dev, old.tomb_dev)]
    srcs = [int(x) for x in rng.choice(N, 8, replace=False)]
    d_old = P.frontier_bfs_batched(ps, srcs, overlay=old, device="cpu")[0]
    for i in rng.choice(M, 60, replace=False):
        ov.remove_edge(int(src[i]), int(dst[i]), None)
        ov.remove_edge(int(dst[i]), int(src[i]), None)
    ov.remove_edge(int(a_s[0]), int(a_d[0]), None)     # below the mark
    b_s = rng.integers(0, N, 150).astype(np.int32)
    b_d = rng.integers(0, N, 150).astype(np.int32)
    ov.append_edges(np.concatenate([b_s, b_d]), np.concatenate([b_d, b_s]),
                    np.zeros(300, np.int32))
    new = ov.view()
    assert new.cap > old.cap and new.seq > old.seq
    for a, b in zip(frozen, (old.src_dev, old.dst_dev, old.tomb_dev)):
        assert torch.equal(a, b)
    d_new = P.frontier_bfs_batched(ps, srcs, overlay=new, device="cpu")[0]
    assert not np.array_equal(d_new, d_old)
    d_again = P.frontier_bfs_batched(ps, srcs, overlay=old, device="cpu")[0]
    assert np.array_equal(d_again, d_old)
    # a third view with no change in between shares the second's tensors
    again = ov.view()
    assert again.tomb_dev is new.tomb_dev and again.src_dev is new.src_dev


def test_empty_overlay_is_ignored_and_masks_refuse_a_live_one():
    rng = np.random.default_rng(SEED)
    src, dst, js, ps = _base(rng)
    ov = DeltaOverlay(ps, min_cap=CAP, device="cpu")
    srcs = [0, 5, 9]
    assert ov.view().empty
    a = P.frontier_bfs_batched(ps, srcs, overlay=ov.view(), device="cpu")
    b = P.frontier_bfs_batched(ps, srcs, device="cpu")
    assert np.array_equal(a[0], b[0])
    ov.remove_edge(int(src[0]), int(dst[0]), None)
    lm = torch.zeros(ov.q_total, dtype=torch.uint8)
    with pytest.raises(ValueError, match="level_masks"):
        P.frontier_bfs_batched(ps, srcs, overlay=ov.view(),
                               level_masks=[lm], device="cpu")


def test_device_none_means_cuda(monkeypatch):
    rng = np.random.default_rng(SEED)
    _, _, _, ps = _base(rng)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeltaOverlay(ps)
