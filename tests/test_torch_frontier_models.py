"""The port's frontier SSSP and WCC (titan_tpu_torch.models.frontier) and
``banded_frontier`` (titan_tpu_torch.ops.compaction) against the JAX
package's, on the CPU.

Every SSSP decision (threshold, segment count, kernel widths, bucket
advance, escalation) comes from integer stats and float32 thresholds that
both packages compute with the same IEEE operations, and the pushes are
min-scatters, whose result does not depend on order; so values AND round
counts must be bit-equal, with slicing, list truncation, overlays, resume
and vetoes, and in the two cohorts. The edge weights are bit-equal by
construction: the same hash of the slot's low 32 bits, and the one
rounding of ``w_range * u + min_w`` that XLA's fused multiply-add gives
(``test_weights_bit_equal_to_jax`` checks it at slots past 2^31)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import titan_tpu.models.frontier as JF
import titan_tpu.ops.compaction as JC
import titan_tpu_torch.models.frontier as PF
import titan_tpu_torch.ops.compaction as PC
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
    """Two hubs with long adjacency lists and a tail."""
    src = [0] * 81 + [200] * 101 + [201] * 60 + [300]
    dst = (list(range(1, 81)) + [300] + list(range(100, 200)) + [300]
           + list(range(202, 261)) + [300] + [301])
    return _sym(302, src, dst)


def _paths():
    """Four disjoint paths: the peel takes the first, and labels creep
    along the other three one hop a round (many WCC rounds)."""
    src, dst, v0 = [], [], 0
    for length in (30, 25, 20, 15):
        src += list(range(v0, v0 + length - 1))
        dst += list(range(v0 + 1, v0 + length))
        v0 += length
    return _sym(v0, src, dst)


def _tail():
    """n = 256 (a power of two, as at scale 26) with a 2-vertex component
    at the very end of the vertex space: the last slice of a round lands
    in the clamp zone of the list's dynamic slice."""
    rng = np.random.default_rng(21)
    src = np.concatenate([rng.integers(0, 200, 800), [254]])
    dst = np.concatenate([rng.integers(0, 200, 800), [255]])
    return _sym(256, src, dst)


GRAPHS = {"random42": lambda: _random(42), "sparse": lambda: _random(1, 150),
          "rmat8": lambda: _rmat(8), "rmat11": lambda: _rmat(11),
          "hubs": _hubs, "path": _path, "paths": _paths, "tail": _tail}
#: graphs run at the default slice budget; on a path every round has the
#: signature of the one before, so each round escalates to full-width
#: [8, 2^23] blocks (JAX's rule, kept): the paths run at small budgets
#: in the sliced test instead
WIDE = ["random42", "sparse", "rmat8", "rmat11", "hubs"]

#: SSSP modes: the default (quantile bands of 2^24 chunks: one band a
#: round here), plain, delta-stepping, small quantile bands (many rounds,
#: the two-level histogram at work), and non-default weights
MODES = {"default": {}, "plain": {"quantile_mass": 0},
         "delta": {"delta": 0.25}, "quantile64": {"quantile_mass": 64},
         "weights": {"min_w": 0.1, "w_range": 0.7, "quantile_mass": 64}}


def _source(snap):
    """bench.py's rule: the first vertex of degree > 0."""
    return int(np.flatnonzero(snap.out_degree > 0)[0])


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(ref, got):
    (a, ra), (b, rb) = ref, got
    assert isinstance(b, np.ndarray) and b.dtype == np.asarray(a).dtype
    assert np.array_equal(_bits(a), _bits(b))
    assert ra == rb


# --------------------------------------------------------------------------
# banded_frontier and the weights
# --------------------------------------------------------------------------

def _band_case(name):
    rng = np.random.default_rng(5)
    L = 1000
    if name == "wrap":
        mask = np.zeros(L, bool)
        mask[[3, 90, 400, 401, 998]] = True
        mass = np.full(L, 1 << 30, np.int32)        # 5 x 2^30 > 2^31
        return mask, mass, 8, 4, 1 << 28
    if name == "edge":
        mask = np.zeros(L, bool)                    # exactly 2^31 - 1
        mask[[10, 20]] = True
        mass = np.zeros(L, np.int32)
        mass[10], mass[20] = 1 << 30, (1 << 30) - 1
        return mask, mass, 4, 4, 1 << 28
    mask = rng.random(L) < (0.0 if name == "empty" else 0.3)
    mass = rng.integers(0, 40, L).astype(np.int32)
    cap = 128 if name == "truncated" else 512
    return mask, mass, cap, 8, 50


@pytest.mark.parametrize("name", ["plain", "truncated", "empty", "wrap",
                                  "edge"])
def test_banded_frontier_matches_jax(name):
    """nf, the overflow flag and the list always; m8 and the bounds
    whenever there is no overflow (the host refuses the round otherwise,
    so JAX's wrapped values are never read)."""
    mask, mass, cap, k_max, budget = _band_case(name)
    ref = [np.asarray(x) for x in JC.banded_frontier(
        jnp.asarray(mask), jnp.asarray(mass), cap, k_max, budget, 1000)]
    got = [x.numpy() for x in PC.banded_frontier(
        torch.from_numpy(mask), torch.from_numpy(mass), cap, k_max, budget,
        1000)]
    nf, m8, overflow, flist, bounds = got
    assert overflow == ref[2] == (name == "wrap")
    assert nf == ref[0] and np.array_equal(flist, ref[3])
    assert flist.dtype == bounds.dtype == np.int32
    if not overflow:
        assert m8 == ref[1] and np.array_equal(bounds, ref[4])
    else:
        assert m8 == 2**31 - 1


_SLOTS = np.concatenate([
    np.random.default_rng(3).integers(0, 1 << 34, 1 << 20),
    [0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1, 2**32, 2**33 + 77,
     282177704 * 8 + 7]]).astype(np.int64)


@pytest.mark.parametrize("wp", [(0.0, 1.0), (0.1, 0.7), (1.0, 0.0),
                                (0.25, 3.0)])
def test_weights_bit_equal_to_jax(wp):
    """The device weights of both packages, over 2^20 random slots below
    2^34 and the edges of 2^31 and 2^32: JAX hashes its wrapped int32
    slot (low 32 bits) inside a jit with float32 parameters, as its push
    does; for (0, 1) both also equal the numpy oracle."""
    wrapped = (_SLOTS & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    ref = np.asarray(jax.jit(lambda s, w: JF._hash_weight_expr(
        s, w[0], w[1]))(jnp.asarray(wrapped), jnp.asarray(
            np.asarray(wp, np.float32))))
    got = PF._hash_weight_expr(torch.from_numpy(_SLOTS), *wp).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(ref.view(np.int32), got.view(np.int32))
    if wp == (0.0, 1.0):
        for oracle in (JF.slot_weights_np, PF.slot_weights_np):
            assert np.array_equal(oracle(_SLOTS), got)


# --------------------------------------------------------------------------
# single runs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", WIDE)
def test_sssp_bit_equal_to_jax(name, mode):
    snap = GRAPHS[name]()
    s = _source(snap)
    ref = JF.frontier_sssp(snap, s, **MODES[mode])
    got = PF.frontier_sssp(snap, s, device="cpu", **MODES[mode])
    _same(ref, got)
    assert got[0][s] == 0.0


@pytest.mark.parametrize("name", list(GRAPHS))
def test_wcc_bit_equal_to_jax(name):
    snap = GRAPHS[name]()
    ref = JF.frontier_wcc(snap)
    got = PF.frontier_wcc(snap, device="cpu")
    _same(ref, got)
    lab = got[0]
    assert (lab <= np.arange(snap.n)).all() and (lab[lab] == lab).all()


#: (kind, mode, SLICE_BUDGET_CHUNKS, SLICE_K_MAX, QUANT_LIST_CAP, graph).
#: A round pushes at most SLICE_K_MAX segments of ~budget chunks, so a
#: vertex heavier than SLICE_K_MAX x budget would never be pushed and its
#: band would never drain (in both packages): every case keeps the
#: largest vertex (116 chunks in rmat8, 13 in hubs) below that product.
SLICED = [("sssp", "default", 2, 64, 1 << 23, "random42"),
          ("sssp", "plain", 32, 64, 1 << 23, "tail"),
          ("sssp", "quantile64", 64, 3, 1 << 23, "rmat8"),
          ("sssp", "quantile64", 1 << 23, 64, 8, "random42"),
          ("sssp", "delta", 8, 3, 16, "hubs"),
          ("sssp", "plain", 64, 64, 1 << 23, "path"),
          ("sssp", "quantile64", 16, 4, 8, "paths"),
          ("sssp", "weights", 8, 64, 1 << 23, "paths"),
          ("wcc", None, 2, 64, 1 << 23, "random42"),
          ("wcc", None, 32, 2, 1 << 23, "tail"),
          ("wcc", None, 64, 3, 1 << 23, "rmat8"),
          ("wcc", None, 4, 2, 1 << 23, "paths")]


@pytest.mark.parametrize("case", SLICED,
                         ids=[f"{c[0]}-{c[1]}-b{c[2]}-k{c[3]}-q{c[4]}-{c[5]}"
                              for c in SLICED])
def test_sliced_rounds_bit_equal_to_jax(case, monkeypatch):
    """Tiny slice budgets (many segments a round, single-hub segments and
    the repeated-signature escalation), few segments a round (the rest of
    a band deferred) and a tiny quantile list (truncation), monkeypatched
    in BOTH packages; the distances equal the plain frontier's at another
    budget."""
    kind, mode, budget, k_max, qcap, name = case
    snap = GRAPHS[name]()
    s = _source(snap)
    if kind == "sssp":
        monkeypatch.setattr(PF, "SLICE_BUDGET_CHUNKS", 1 << 10)
        whole = PF.frontier_sssp(snap, s, device="cpu", quantile_mass=0,
                                 **{k: v for k, v in MODES[mode].items()
                                    if k != "quantile_mass"})
    for mod in (JF, PF):
        monkeypatch.setattr(mod, "SLICE_BUDGET_CHUNKS", budget)
        monkeypatch.setattr(mod, "SLICE_K_MAX", k_max)
        monkeypatch.setattr(mod, "QUANT_LIST_CAP", qcap)
    if kind == "wcc":
        _same(JF.frontier_wcc(snap), PF.frontier_wcc(snap, device="cpu"))
        return
    ref = JF.frontier_sssp(snap, s, **MODES[mode])
    got = PF.frontier_sssp(snap, s, device="cpu", **MODES[mode])
    _same(ref, got)
    # slicing changes rounds, never the fixpoint
    assert np.array_equal(got[0], whole[0])


def _states(run, read_back=False):
    """Run with a checkpoint hook; returns (result, {round: state}). JAX
    donates its value buffers to the next push, so its states are read
    back inside the hook."""
    caps = {}

    def keep(rounds, state):
        caps[rounds] = {k: np.asarray(v) if read_back and hasattr(v, "shape")
                        else v for k, v in state.items()}
    return run(keep), caps


@pytest.mark.parametrize("kind", ["quantile64", "delta", "plain", "wcc"])
def test_checkpoint_and_resume_bit_equal_to_jax(kind):
    """The checkpoints carry JAX's state at every round boundary (the
    [n+1] arrays, the bucket, the quantile mass, the peel's levels); the
    port resumed from a middle state, its own or the JAX package's read
    back as numpy, ends bit-equal to the uninterrupted run, rounds
    included; a state handed out is not changed by the run going on."""
    snap = _paths() if kind == "wcc" else _rmat(8)
    s = _source(snap)
    if kind == "wcc":
        def jrun(ck, **kw):
            return JF.frontier_wcc(snap, checkpoint=ck, **kw)

        def prun(ck, **kw):
            return PF.frontier_wcc(snap, checkpoint=ck, device="cpu", **kw)
    else:
        def jrun(ck, **kw):
            return JF.frontier_sssp(snap, s, checkpoint=ck, **MODES[kind],
                                    **kw)

        def prun(ck, **kw):
            return PF.frontier_sssp(snap, s, checkpoint=ck, device="cpu",
                                    **MODES[kind], **kw)
    ref, jcaps = _states(jrun, read_back=True)
    got, pcaps = _states(prun)
    _same(ref, got)
    assert sorted(jcaps) == sorted(pcaps) and len(pcaps) >= 2
    first = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in pcaps[min(pcaps)].items()}
    for r in pcaps:
        j, p = jcaps[r], pcaps[r]
        assert sorted(j) == sorted(p)
        for key in j:
            if key in ("val", "val_exp"):
                assert p[key].shape == (snap.n + 1,)
                assert np.array_equal(_bits(j[key]), _bits(p[key].numpy()))
            else:
                assert j[key] == p[key], key
    for key, v in first.items():          # still as it was handed out
        same = torch.equal(v, pcaps[min(pcaps)][key]) if torch.is_tensor(v) \
            else v == pcaps[min(pcaps)][key]
        assert same, key
    mid = sorted(pcaps)[len(pcaps) // 2]
    for state in (pcaps[mid], jcaps[mid]):
        resume = {**state, "rounds": mid}
        _same(ref, prun(None, resume=resume))


@pytest.mark.parametrize("kind", ["sssp", "wcc"])
def test_on_round_veto_matches_jax(kind):
    snap = _paths() if kind == "wcc" else _rmat(8)
    s = _source(snap)
    seen = {"jax": [], "port": []}

    def veto(who):
        def cb(rounds):
            seen[who].append(rounds)
            return rounds < 2
        return cb
    for who, fn in (("jax", JF), ("port", PF)):
        kw = {} if who == "jax" else {"device": "cpu"}
        with pytest.raises(fn.RoundInterrupted) as e:
            if kind == "wcc":
                fn.frontier_wcc(snap, on_round=veto(who), **kw)
            else:
                fn.frontier_sssp(snap, s, on_round=veto(who), **kw)
        assert e.value.rounds == 2
    assert seen["jax"] == seen["port"] == [0, 1, 2]


def test_max_rounds_cut_matches_jax():
    snap = _rmat(11)
    s = _source(snap)
    _same(JF.frontier_sssp(snap, s, max_rounds=3),
          PF.frontier_sssp(snap, s, max_rounds=3, device="cpu"))
    _same(JF.frontier_wcc(snap, max_rounds=1),
          PF.frontier_wcc(snap, max_rounds=1, device="cpu"))


def test_trace_hooks_record_every_round():
    """bench.py's hooks on the graph dict: one (band, nf, m8, t, plan_s)
    a round, the same band/nf/m8 as JAX's, with or without the drain."""
    snap = _rmat(11)
    s = _source(snap)
    import titan_tpu.models.bfs_hybrid as H
    import titan_tpu_torch.models.bfs_hybrid as P
    jg = H.build_chunked_csr(snap)
    traces = []
    for drain in (False, True):
        tj, tp = [], []
        jg["_trace_rounds"], jg["_trace_plan_drain"] = tj, drain
        pg = P.build_chunked_csr(snap, device="cpu")
        pg["_trace_rounds"], pg["_trace_plan_drain"] = tp, drain
        ref = JF.frontier_sssp(jg, s, quantile_mass=64)
        got = PF.frontier_sssp(pg, s, quantile_mass=64, device="cpu")
        _same(ref, got)
        assert [r[:3] for r in tj] == [r[:3] for r in tp]
        assert len(tp) > got[1] and all(r[4] >= 0.0 for r in tp)
        traces.append(tp)
    del jg["_trace_rounds"], jg["_trace_plan_drain"]
    assert [r[:3] for r in traces[0]] == [r[:3] for r in traces[1]]


def test_overflowed_round_is_refused():
    """Three improved vertices of 2^30 chunks each: the listed mass passes
    int32 and both packages refuse the round before any push."""
    n = 4
    dstT = np.full((8, 8), n + 1, np.int32)
    degc = np.asarray([1 << 30] * 3 + [0, 0], np.int32)
    host = {"colstart": np.zeros(n + 1, np.int32), "degc": degc,
            "deg": np.asarray([1] * 3 + [0, 0], np.int32), "dstT": dstT}
    import titan_tpu_torch.olap.graph500 as PG
    jg = {"dstT": jnp.asarray(dstT), "n": n, "q_total": 8,
          **{k: jnp.asarray(host[k]) for k in ("colstart", "degc", "deg")}}
    pg = PG.graph_from_numpy(host, device="cpu")
    resume = {"val": np.asarray([0, 1, 2, 3, PF.IINF], np.int32),
              "val_exp": np.asarray([1, 2, 3, 3, PF.IINF], np.int32),
              "rounds": 0, "levels": 0}
    with pytest.raises(RuntimeError, match="overflowed int32"):
        JF.frontier_wcc(jg, resume=resume)
    with pytest.raises(RuntimeError, match="overflowed int32"):
        PF.frontier_wcc(pg, resume=resume, device="cpu")


# --------------------------------------------------------------------------
# overlays
# --------------------------------------------------------------------------

N, M = 192, 900


def _overlays(seed, n_add=60, n_rm=40, isolate=0):
    """The same edits through both packages' overlays on the
    n=192/m=900 random graph (vertices past N - isolate have no base
    edges): adds symmetrized, base edges removed both ways."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N - isolate, M).astype(np.int32)
    dst = rng.integers(0, N - isolate, M).astype(np.int32)
    js = _sym(N, src, dst)
    ps = PS.from_numpy(js)
    oj = JaxOverlay(js, min_cap=256)
    op = DeltaOverlay(ps, min_cap=256, device="cpu")
    a_s = rng.integers(0, N, n_add).astype(np.int32)
    a_d = rng.integers(0, N, n_add).astype(np.int32)
    if isolate:
        # a chain into the isolated vertices: reachable through adds only
        a_s = np.concatenate([a_s, np.arange(N - isolate - 1, N - 1)])
        a_d = np.concatenate([a_d, np.arange(N - isolate, N)])
    rm = rng.choice(M, n_rm, replace=False)
    for ov in (oj, op):
        ov.append_edges(np.concatenate([a_s, a_d]),
                        np.concatenate([a_d, a_s]),
                        np.zeros(2 * len(a_s), np.int32))
        for i in rm:
            ov.remove_edge(int(src[i]), int(dst[i]), None)
            ov.remove_edge(int(dst[i]), int(src[i]), None)
    return js, ps, oj.view(), op.view()


@pytest.mark.parametrize("case", ["sssp", "sssp_unit", "sssp_plain", "wcc",
                                  "chain_sssp", "chain_wcc"])
def test_overlay_runs_bit_equal_to_jax(case):
    """Adds and tombstones through each package's own overlay: values and
    rounds bit-equal (the tombstone test by column byte agrees with JAX's
    int32 slot below 2^28 columns); the chain cases reach vertices with
    no base edge through the empty-plan relax; the snapshot's attached
    view is the default."""
    js, ps, vj, vp = _overlays(7, isolate=3 if "chain" in case else 0)
    s = _source(js)
    assert vp.tomb_count > 0 and vp.count > 0
    if case.endswith("wcc"):
        ref = JF.frontier_wcc(js, overlay=vj)
        got = PF.frontier_wcc(ps, overlay=vp, device="cpu")
    else:
        kw = {"sssp": {}, "sssp_unit": {"min_w": 1.0, "w_range": 0.0},
              "sssp_plain": {"quantile_mass": 0},
              "chain_sssp": {"quantile_mass": 0}}[case]
        ref = JF.frontier_sssp(js, s, overlay=vj, **kw)
        got = PF.frontier_sssp(ps, s, overlay=vp, device="cpu", **kw)
    _same(ref, got)
    if case == "chain_wcc":
        assert (got[0][N - 3:] == got[0][N - 4]).all()
    elif case == "chain_sssp":
        assert (got[0][N - 3:] < PF.FINF).all()
    ps._live_overlay = vp
    again = PF.frontier_wcc(ps, device="cpu") if case.endswith("wcc") \
        else PF.frontier_sssp(ps, s, device="cpu", **kw)
    _same(got, again)


def test_overlay_wcc_equals_a_rebuild():
    """Base + overlay labels equal a snapshot rebuilt from the final
    edges (the port alone: the rebuild's slots differ, labels do not)."""
    rng = np.random.default_rng(11)
    src = rng.integers(0, N, M).astype(np.int32)
    dst = rng.integers(0, N, M).astype(np.int32)
    ps = PS.from_numpy(_sym(N, src, dst))
    ov = DeltaOverlay(ps, min_cap=256, device="cpu")
    a_s, a_d = np.asarray([5, 17], np.int32), np.asarray([150, 3], np.int32)
    ov.append_edges(np.concatenate([a_s, a_d]), np.concatenate([a_d, a_s]),
                    np.zeros(4, np.int32))
    keep = np.ones(M, bool)
    for i in rng.choice(M, 300, replace=False):
        ov.remove_edge(int(src[i]), int(dst[i]), None)
        ov.remove_edge(int(dst[i]), int(src[i]), None)
        keep[i] = False
    fs = np.concatenate([src[keep], a_s])
    fd = np.concatenate([dst[keep], a_d])
    rebuilt = PS.from_arrays(N, np.concatenate([fs, fd]),
                             np.concatenate([fd, fs]))
    lab_ov, _ = PF.frontier_wcc(ps, overlay=ov.view(), device="cpu")
    lab_rb, _ = PF.frontier_wcc(rebuilt, device="cpu")
    assert np.array_equal(lab_ov, lab_rb)


# --------------------------------------------------------------------------
# cohorts
# --------------------------------------------------------------------------

def _cohort_sources(snap, K=5):
    rng = np.random.default_rng(9)
    nz = np.flatnonzero(snap.out_degree > 0)
    srcs = [int(x) for x in rng.choice(nz, K, replace=True)]
    srcs[1] = srcs[0]                       # a duplicate member
    return srcs


@pytest.mark.parametrize("mode", ["default", "delta", "plain", "quantile64"])
@pytest.mark.parametrize("name", ["random42", "rmat11"])
def test_sssp_cohort_bit_equal_to_jax_and_solo(name, mode):
    snap = GRAPHS[name]()
    srcs = _cohort_sources(snap)
    ref = JF.frontier_sssp_batched(snap, srcs, **MODES[mode])
    got = PF.frontier_sssp_batched(snap, srcs, device="cpu", **MODES[mode])
    assert ref[1] == got[1] and ref[2] == got[2] == [None] * len(srcs)
    for k, s in enumerate(srcs):
        assert np.array_equal(_bits(ref[0][k]), _bits(got[0][k]))
        solo = PF.frontier_sssp(snap, s, device="cpu", **MODES[mode])
        _same(solo, (got[0][k], got[1][k]))


def test_sssp_cohort_hooks_and_overlay_match_jax():
    """Per-member vetoes (member 2 leaves at round 1), per-member
    checkpoints equal to JAX's, and an overlay, in one cohort."""
    js, ps, vj, vp = _overlays(3)
    srcs = _cohort_sources(js, 4)
    logs = {}

    def hooks(who):
        log = logs.setdefault(who, [])

        def on_round(k, rounds):
            return not (k == 2 and rounds >= 1)

        def checkpoint(k, rounds, state):
            log.append((k, rounds, _bits(np.asarray(state["val"])).copy(),
                        state["bucket_end"], state["quantile_mass"]))
        return {"on_round": on_round, "checkpoint": checkpoint}
    ref = JF.frontier_sssp_batched(js, srcs, overlay=vj, quantile_mass=64,
                                   **hooks("jax"))
    got = PF.frontier_sssp_batched(ps, srcs, overlay=vp, quantile_mass=64,
                                   device="cpu", **hooks("port"))
    assert ref[1] == got[1] and ref[2] == got[2]
    assert got[2][2] == 1 and got[0][2] is None
    for k in (0, 1, 3):
        assert np.array_equal(_bits(ref[0][k]), _bits(got[0][k]))
    assert len(logs["jax"]) == len(logs["port"])
    for a, b in zip(logs["jax"], logs["port"]):
        assert a[:2] == b[:2] and np.array_equal(a[2], b[2]) \
            and a[3:] == b[3:]


@pytest.mark.parametrize("overlay", [False, True])
def test_wcc_cohort_bit_equal_to_jax_and_solo(overlay):
    js, ps, vj, vp = _overlays(5)
    kw_j = {"overlay": vj} if overlay else {}
    kw_p = {"overlay": vp} if overlay else {}
    stops = {"jax": [], "port": []}

    def veto(who):
        def cb(k, rounds):
            stops[who].append((k, rounds))
            return k != 1 or rounds < 1
        return cb
    ref = JF.frontier_wcc_batched(js, 3, on_round=veto("jax"), **kw_j)
    got = PF.frontier_wcc_batched(ps, 3, on_round=veto("port"),
                                  device="cpu", **kw_p)
    assert ref[1] == got[1] and ref[2] == got[2] and stops["jax"] == \
        stops["port"]
    solo = PF.frontier_wcc(ps, device="cpu", **kw_p)
    for k in (0, 2):
        assert np.array_equal(np.asarray(ref[0][k]), got[0][k])
        _same(solo, (got[0][k], got[1][k]))


# --------------------------------------------------------------------------
# devices
# --------------------------------------------------------------------------

def test_device_none_means_cuda(monkeypatch):
    snap = _random(42)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: PF.frontier_sssp(snap, 0),
                 lambda: PF.frontier_wcc(snap),
                 lambda: PF.frontier_sssp_batched(snap, [0, 1]),
                 lambda: PF.frontier_wcc_batched(snap, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_graph_on_another_device_is_refused():
    import titan_tpu_torch.models.bfs_hybrid as P
    g = P.build_chunked_csr(_random(42), device="cpu")
    with pytest.raises(ValueError, match="device"):
        PF.frontier_sssp(g, 0, device="meta")


# --------------------------------------------------------------------------
# the card's checks (chip_smoke.py phases 8 and 9), run here on the CPU
# --------------------------------------------------------------------------

def test_smoke_checks_accept_the_port_and_reject_mutations():
    """``check_sssp`` and ``check_wcc`` pass the port's results and fail
    on each kind of wrong answer: a distance raised by one ulp (no tight
    in-edge), one halved (an edge can lower its neighbour), a reached
    vertex reported unreached, a nonzero source; a label raised above
    its vertex, and one vertex split off. (Two components sharing one
    label pass these rules: the card's phases compare the labels with
    scipy's at scale 22 and the giant's set with a BFS at scale 26.)"""
    import chip_smoke as cs
    import titan_tpu_torch.models.bfs_hybrid as P
    snap = _rmat(11)
    g = P.build_chunked_csr(snap, device="cpu")
    s = _source(snap)
    dist, _ = PF.frontier_sssp(g, s, return_device=True, device="cpu")
    label, _ = PF.frontier_wcc(g, return_device=True, device="cpu")
    dist, label = dist.clone(), label.clone()
    assert cs.check_sssp(PF, g, dist, s) == int((dist < PF.FINF).sum())
    assert cs.check_wcc(PF, g, label) == len(torch.unique(label))
    far = int(torch.argmax(torch.where(dist < PF.FINF, dist, -1.0)))
    finf = torch.tensor(float(PF.FINF))
    for mutate in (lambda d: torch.nextafter(d[far], finf),
                   lambda d: d[far] / 2,
                   lambda d: finf):
        d = dist.clone()
        d[far] = mutate(d)
        with pytest.raises(RuntimeError):
            cs.check_sssp(PF, g, d, s)
    d = dist.clone()
    d[s] = 1e-3
    with pytest.raises(RuntimeError, match="source"):
        cs.check_sssp(PF, g, d, s)
    big = int(torch.mode(label).values)
    members = torch.nonzero(label == big).flatten()
    for v, new in ((int(members[0]), int(members[0]) + 1),
                   (int(members[-1]), int(members[-1]))):
        lab = label.clone()
        lab[v] = new
        with pytest.raises(RuntimeError):
            cs.check_wcc(PF, g, lab)
