"""The port's epoch merge (titan_tpu_torch.ops.epoch_merge) and the host
merge it relies on (olap/snapshot.merge_delta, _merge_out_csr) against
the JAX package's, on the CPU.

The same snapshot is built in both packages and the two overlays get the
same appends and removals. Then the port's ``merge_chunked_csr`` must be
bit-equal to JAX's and to the host oracle (``from_arrays``' full stable
sort, then ``build_chunked_csr``) on the shapes of
``tests/test_live_compact_device.py``; its helpers
(``merged_degrees_host``, ``_upper_bound_segmented``, ``_bitmap_bits``,
``LazyHostMirror``) equal JAX's; and ``merge_delta`` with its incremental
out-CSR is bit-equal to JAX's, to ``from_arrays`` and to a fresh
``out_csr()``."""

import numpy as np
import pytest
import torch

import titan_tpu.models.bfs_hybrid as JH
import titan_tpu.ops.epoch_merge as JM
from titan_tpu.olap.live.overlay import DeltaOverlay as JaxOverlay
from titan_tpu.olap.tpu import snapshot as JS
import titan_tpu_torch.models.bfs_hybrid as PH
import titan_tpu_torch.ops.epoch_merge as PM
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.live import DeltaOverlay

#: the repo-shared test shape
N, M, SEED = 192, 900, 42

#: tests/test_live_compact_device.py's shapes: (adds, removes, labeled,
#: kill an appended row in place)
SHAPES = [(120, 40, False, True),     # mixed + a dead add
          (120, 40, True, True),      # labeled mixed
          (120, 0, False, False),     # adds only
          (0, 60, True, False),       # tombstones only
          (300, 10, False, False)]    # adds dominate (cap growth)


def base(seed=SEED, labeled=False, n=N, m=M):
    """The same snapshot in both packages, and the rng that goes on to
    draw the mutations."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    labs = rng.integers(0, 3, m).astype(np.int32) if labeled else None
    js = JS.from_arrays(n, src, dst, labels=labs)
    return js, PS.from_numpy(js), (src, dst, labs), rng


def mutate(js, ps, edges, rng, adds, removes, kill=False):
    """One JAX overlay and one port overlay given the same appends, base
    removals and (with ``kill``) an appended row killed in place."""
    src, dst, labs = edges
    jo = JaxOverlay(js, min_cap=64)
    po = DeltaOverlay(ps, min_cap=64, device="cpu")
    a = (rng.integers(0, js.n, adds).astype(np.int32),
         rng.integers(0, js.n, adds).astype(np.int32),
         rng.integers(0, 3, adds).astype(np.int32))
    rm = rng.choice(len(src), removes, replace=False)
    for ov in (jo, po):
        if adds:
            ov.append_edges(*a)
        for i in rm:
            ov.remove_edge(int(src[i]), int(dst[i]),
                           int(labs[i]) if labs is not None else None)
        if kill and adds > 4:
            assert ov.remove_edge(int(a[0][2]), int(a[1][2]),
                                  int(a[2][2]))
    assert np.array_equal(jo.tomb_row_mask, po.tomb_row_mask)
    return jo, po


def same_csr(got: dict, want: dict):
    assert got["q_total"] == want["q_total"]
    assert got["n"] == want["n"]
    for k in ("dstT", "colstart", "degc", "deg"):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype == np.int32, k
        assert a.shape == b.shape and np.array_equal(a, b), k


def oracle_of(ps, po):
    """The host oracle: the full stable re-sort of the kept base rows and
    the live adds (the compactor's ``merge``)."""
    keep = ~po.tomb_row_mask
    a_src, a_dst, a_lab = po.live_adds()
    labs = None if ps.labels is None else \
        np.concatenate([ps.labels[keep], a_lab])
    return PS.from_arrays(ps.n, np.concatenate([ps.src[keep], a_src]),
                          np.concatenate([ps.dst[keep], a_dst]),
                          ps.vertex_ids, labels=labs,
                          label_names=ps.label_names)


def as_numpy(d: dict) -> dict:
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)
                if k in ("dstT", "colstart", "degc", "deg") else v)
            for k, v in d.items()}


@pytest.mark.parametrize("adds,removes,labeled,kill", SHAPES)
@pytest.mark.parametrize("seed", [1, SEED])
def test_merge_bit_equal_to_jax_and_to_the_host_oracle(seed, adds, removes,
                                                       labeled, kill):
    js, ps, edges, rng = base(seed, labeled)
    jo, po = mutate(js, ps, edges, rng, adds, removes, kill)
    jdeg = JM.merged_degrees_host(js, jo)
    pdeg = PM.merged_degrees_host(ps, po)
    for a, b in zip(jdeg[:3], pdeg[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert jdeg[3] == pdeg[3]
    jg = JM.merge_chunked_csr(JH.build_chunked_csr(js), jo.view(),
                              q_total_new=jdeg[3], e_base=js.num_edges)
    pg = PM.merge_chunked_csr(PH.build_chunked_csr(ps, "cpu"), po.view(),
                              q_total_new=pdeg[3], e_base=ps.num_edges)
    same_csr(as_numpy(pg), as_numpy(jg))
    oracle = oracle_of(ps, po)
    same_csr(as_numpy(pg), as_numpy(PH.build_chunked_csr(oracle, "cpu")))
    assert pdeg[3] == pg["q_total"]
    for a, k in zip(pdeg[:3], ("deg", "degc", "colstart")):
        assert np.array_equal(a, pg[k].numpy()), k
    assert pg["dstT"].is_contiguous()


def test_merge_rejects_what_the_int32_layout_cannot_express(monkeypatch):
    js, ps, edges, rng = base()
    _, po = mutate(js, ps, edges, rng, 20, 5)
    g = PH.build_chunked_csr(ps, "cpu")
    q_new = PM.merged_degrees_host(ps, po)[3]
    with pytest.raises(ValueError, match="non-empty"):
        PM.merge_chunked_csr(g, po.view(), q_total_new=q_new, e_base=0)
    stale = dict(g, q_total=g["q_total"] + 1)
    with pytest.raises(ValueError, match="stale epoch"):
        PM.merge_chunked_csr(stale, po.view(), q_total_new=q_new,
                             e_base=ps.num_edges)
    monkeypatch.setattr(PM, "fits_int32", lambda q: False)
    with pytest.raises(ValueError, match="int32"):
        PM.merge_chunked_csr(g, po.view(), q_total_new=q_new,
                             e_base=ps.num_edges)


@pytest.mark.parametrize("q", [0, 1, (1 << 28) - 1, 1 << 28,
                               282_177_705])
def test_fits_int32_equals_jax(q):
    assert PM.fits_int32(q) == JM.fits_int32(q)


def test_merged_degrees_host_equals_the_oracle_layout():
    js, ps, edges, rng = base(labeled=True)
    _, po = mutate(js, ps, edges, rng, 80, 30, kill=True)
    deg, degc, colstart, q_new = PM.merged_degrees_host(ps, po)
    g = PH.build_chunked_csr(oracle_of(ps, po), "cpu")
    assert q_new == g["q_total"]
    assert np.array_equal(deg, g["deg"].numpy())
    assert np.array_equal(degc, g["degc"].numpy())
    assert np.array_equal(colstart, g["colstart"].numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_upper_bound_segmented_equals_jax_and_numpy(seed):
    """Random ascending segments, empty ones included, needles below,
    inside, equal to and above their segment's values."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 12, 40)
    lens[::7] = 0                                  # empty segments
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flat = np.concatenate([np.sort(rng.integers(0, 50, k))
                           for k in lens]).astype(np.int32)
    lo = np.repeat(starts, 5).astype(np.int32)
    hi = np.repeat(starts + lens, 5).astype(np.int32)
    needle = rng.integers(-2, 53, lo.shape[0]).astype(np.int32)
    got = PM._upper_bound_segmented(torch.from_numpy(flat),
                                    torch.from_numpy(lo),
                                    torch.from_numpy(hi),
                                    torch.from_numpy(needle))
    want = JM._upper_bound_segmented(jnp.asarray(flat), jnp.asarray(lo),
                                     jnp.asarray(hi), jnp.asarray(needle))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    ref = [a + int(np.searchsorted(flat[a:b], x, side="right"))
           for a, b, x in zip(lo, hi, needle)]
    assert got.tolist() == ref


def test_bitmap_bits_equals_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(SEED)
    tomb = rng.integers(0, 256, 37).astype(np.uint8)
    got = PM._bitmap_bits(torch.from_numpy(tomb), 37)
    want = np.asarray(JM._bitmap_bits(jnp.asarray(tomb), 37))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    slots = np.flatnonzero(got.numpy())
    assert all(tomb[s >> 3] >> (s & 7) & 1 for s in slots)


def test_lazy_host_mirror_equals_jax_and_the_layout():
    js, ps, edges, rng = base(labeled=True)
    jo, po = mutate(js, ps, edges, rng, 50, 20)
    _, jdegc, jcol, _ = JM.merged_degrees_host(js, jo)
    _, degc, col, _ = PM.merged_degrees_host(ps, po)
    jm = JS.merge_delta(js, ~jo.tomb_row_mask, *jo.live_adds())
    pm = PS.merge_delta(ps, ~po.tomb_row_mask, *po.live_adds())
    jmirror = JM.LazyHostMirror(jm, jcol, jdegc)
    mirror = PM.LazyHostMirror(pm, col, degc)
    assert np.array_equal(mirror["colstart"], jmirror["colstart"])
    assert np.array_equal(mirror["degc"], jmirror["degc"])
    assert np.array_equal(mirror["dstT"], jmirror["dstT"])
    assert mirror["dstT"] is mirror["dstT"]             # built once
    assert np.array_equal(mirror["dstT"],
                          PH.build_chunked_csr(pm, "cpu")["dstT"].numpy())


def fresh_out_csr(snap):
    """``out_csr()`` computed from scratch on an uncached copy."""
    fresh = PS.GraphSnapshot(snap.n, snap.vertex_ids, snap.src, snap.dst,
                             snap.indptr_in, snap.out_degree, {},
                             snap.labels, dict(snap.label_names))
    dbs, ip = fresh.out_csr()
    return dbs, ip, fresh._out_csr_order


@pytest.mark.parametrize("adds,removes", [(0, 0), (40, 0), (0, 60),
                                          (50, 80)])
@pytest.mark.parametrize("seed", [3, SEED])
def test_merge_delta_bit_equal_to_jax_and_from_arrays(seed, adds, removes):
    js, ps, edges, rng = base(seed, labeled=True)
    js.out_csr()
    ps.out_csr()                      # the overlay's own build caches it
    jo, po = mutate(js, ps, edges, rng, adds, removes)
    keep = ~po.tomb_row_mask
    jm = JS.merge_delta(js, ~jo.tomb_row_mask, *jo.live_adds())
    pm = PS.merge_delta(ps, keep, *po.live_adds())
    oracle = oracle_of(ps, po)
    for attr in ("src", "dst", "indptr_in", "out_degree", "labels",
                 "vertex_ids"):
        got = getattr(pm, attr)
        for want in (getattr(jm, attr), getattr(oracle, attr)):
            assert got.dtype == want.dtype, attr
            assert np.array_equal(got, want), attr
    assert pm.label_names == jm.label_names
    # the out-CSR cache carried over incrementally
    assert pm._out_csr is not None and pm._out_csr_order is not None
    ref_dbs, ref_ip, ref_order = fresh_out_csr(pm)
    j_dbs, j_ip = jm._out_csr
    for got, want in ((pm._out_csr[0], ref_dbs), (pm._out_csr[0], j_dbs),
                      (pm._out_csr[1], ref_ip), (pm._out_csr[1], j_ip)):
        assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(pm._out_csr_order, np.int64),
                          np.asarray(ref_order, np.int64))
    assert np.array_equal(np.asarray(pm._out_csr_order, np.int64),
                          np.asarray(jm._out_csr_order, np.int64))


def test_merge_delta_without_a_cached_out_csr_builds_none():
    js, ps, edges, rng = base()
    _, po = mutate(js, ps, edges, rng, 10, 0)
    ps._out_csr = ps._out_csr_order = None   # the overlay's build cached it
    pm = PS.merge_delta(ps, np.ones(ps.num_edges, bool), *po.live_adds())
    assert pm._out_csr is None and pm.labels is None
    with pytest.raises(IndexError):
        PS.merge_delta(ps, np.ones(ps.num_edges, bool), [0], [N], None)


def test_merge_runs_under_the_device_profiler():
    from titan_tpu_torch.obs import devprof
    from titan_tpu_torch.utils.metrics import MetricManager

    js, ps, edges, rng = base()
    _, po = mutate(js, ps, edges, rng, 30, 10)
    g = PH.build_chunked_csr(ps, "cpu")
    q_new = PM.merged_degrees_host(ps, po)[3]
    with devprof.DeviceCostProfiler(metrics=MetricManager()) as prof:
        PM.merge_chunked_csr(g, po.view(), q_total_new=q_new,
                             e_base=ps.num_edges)
    assert prof.kernel_stats()["ops.epoch_merge"]["calls"] == 1
