"""The port's live plane (titan_tpu_torch/olap/live/plane.py) with
``SnapshotPool(live=)`` and ``JobScheduler(live=)``, held to the JAX
package's on twin graphs: the same seeded operations on a JAX-package
graph and a port graph (``SimpleBulkPlacement`` seeded in both, so ids
agree), one plane over each, the port's on ``device="cpu"``.

Each test mirrors one of tests/test_live_plane.py or the plane tests of
tests/test_live_compact_device.py and holds the two planes equal: the
leased snapshots field by field, the overlay views (adds, labels,
tombstones, seq), ``epoch_info``, ``stats()`` (histograms by count, the
rest exactly), served results and ``ran_epoch``. BFS rows are also held
to a rebuilt snapshot, as the JAX tests hold theirs. Integer results are
exact; PageRank is held at rtol 1e-5."""

import threading

import numpy as np
import pytest
import torch

import titan_tpu
import titan_tpu.olap.api as JA
import titan_tpu.olap.serving.scheduler as JSCH
import titan_tpu.utils.metrics as JM
import titan_tpu_torch
import titan_tpu_torch.olap.api as PA
import titan_tpu_torch.olap.serving.scheduler as PSCH
import titan_tpu_torch.utils.metrics as PM
from titan_tpu.ids.placement import SimpleBulkPlacement as JPlace
from titan_tpu.models import bfs_hybrid as H
from titan_tpu.olap import live as JL
from titan_tpu.olap.serving.pool import SnapshotPool as JPool
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu_torch.ids.placement import SimpleBulkPlacement as PPlace
from titan_tpu_torch.models import bfs_hybrid as P
from titan_tpu_torch.olap import live as PL
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.serving.hbm import snapshot_csr_bytes
from titan_tpu_torch.olap.serving.pool import SnapshotPool as PPool

CPU = torch.device("cpu")
PATH = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6)]
FIELDS = ("n", "vertex_ids", "src", "dst", "indptr_in", "out_degree",
          "labels", "label_names", "epoch")
HISTOGRAMS = ("apply_ms", "compact_ms", "compact_device_ms")
WAIT = 120
PAGERANK_RTOL = 1e-5


class Twin:
    """The JAX plane test graph (10 vertices, a path of 6 ``link`` edges)
    in both packages, changed by the same calls. ``ids`` lists the
    vertices in the order they were made."""

    def __init__(self, seed: int = 5):
        self.g = {}
        for which, pkg, place in (("jax", titan_tpu, JPlace),
                                  ("port", titan_tpu_torch, PPlace)):
            g = pkg.open("inmemory")
            g.id_assigner.placement = place(g.idm.num_partitions,
                                            batch_size=4, seed=seed)
            self.g[which] = g
        self.ids = self.each(self._populate)

    @staticmethod
    def _populate(g):
        tx = g.new_transaction()
        vs = [tx.add_vertex("node", name=f"v{i:02d}") for i in range(10)]
        for a, b in PATH:
            vs[a].add_edge("link", vs[b])
        tx.commit()
        return [v.id for v in vs]

    def each(self, fn, *args):
        out = [fn(self.g[w], *args) for w in ("jax", "port")]
        assert out[0] == out[1]
        return out[1]

    def commit(self, fn) -> None:
        def go(g):
            tx = g.new_transaction()
            fn(tx, self.ids)
            tx.commit()
        self.each(go)

    def add_edge(self, i: int, j: int) -> None:
        self.commit(lambda tx, ids: tx.vertex(ids[i]).add_edge(
            "link", tx.vertex(ids[j])))

    def close(self) -> None:
        for g in self.g.values():
            g.close()


@pytest.fixture
def twin():
    tw = Twin()
    yield tw
    tw.close()


def planes(tw, lax: bool = True, **kw):
    """A plane over each twin; ``lax`` gives both the JAX tests' policy
    (fill and tombstones at 0.99), so tiny graphs do not compact on every
    delta."""
    jkw, pkw = dict(kw), dict(kw)
    if lax:
        jkw["compactor"] = JL.EpochCompactor(max_fill=0.99,
                                             max_tomb_fraction=0.99)
        pkw["compactor"] = PL.EpochCompactor(max_fill=0.99,
                                             max_tomb_fraction=0.99,
                                             device="cpu")
    jp = JL.LiveGraphPlane(tw.g["jax"], metrics=JM.MetricManager(), **jkw)
    pp = PL.LiveGraphPlane(tw.g["port"], metrics=PM.MetricManager(),
                           device="cpu", **pkw)
    return jp, pp


def same_snapshot(js, ps) -> None:
    for f in FIELDS:
        a, b = getattr(js, f), getattr(ps, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f
    assert js.vertex_values.keys() == ps.vertex_values.keys()
    assert js._build_params == ps._build_params


def same_view(vj, vp) -> None:
    assert isinstance(vp, PL.OverlayView)
    for f in ("n", "cap", "count", "tomb_count", "seq", "slot_base"):
        assert getattr(vj, f) == getattr(vp, f), f
    for f in ("src_dev", "dst_dev", "tomb_dev"):
        a, b = np.asarray(getattr(vj, f)), getattr(vp, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def same_overlay(jo, po) -> None:
    """The overlays' host state: adds with their labels, tombstones."""
    assert jo.stats() == po.stats()
    for a, b in zip(jo.live_adds(), po.live_adds()):
        assert np.array_equal(a, b)
    assert np.array_equal(jo.tomb_row_mask, po.tomb_row_mask)


def leases(jp, pp):
    """Both planes' ``lease_state()``, held equal."""
    (js, jv, ji), (ps, pv, pi) = jp.lease_state(), pp.lease_state()
    same_snapshot(js, ps)
    same_view(jv, pv)
    same_overlay(jp.overlay, pp.overlay)
    assert ji == pi
    assert ps._live_overlay is pv
    return (js, jv, ji), (ps, pv, pi)


def same_stats(sj: dict, sp: dict) -> None:
    assert sj.keys() == sp.keys()
    for k in sj:
        if k in HISTOGRAMS:
            assert sj[k]["count"] == sp[k]["count"], k
        else:
            assert sj[k] == sp[k], k


def bfs(lj, lp, sources=(0,)):
    """The batched BFS over each lease (base + its overlay view), held
    equal; returns the port's rows."""
    (js, jv, _), (ps, pv, _) = lj, lp
    dj, lvj, cj = H.frontier_bfs_batched(js, list(sources), overlay=jv)
    dp, lvp, cp = P.frontier_bfs_batched(ps, list(sources), overlay=pv,
                                         device="cpu")
    assert np.array_equal(np.asarray(dj), dp)
    assert np.array_equal(lvj, lvp) and np.array_equal(cj, cp)
    return dp


def rebuilt_bfs(g, sources=(0,)):
    return P.frontier_bfs_batched(PS.build(g, directed=False),
                                  list(sources), device="cpu")[0]


def test_edge_deltas_flow_through_overlay_not_rebuild(twin):
    jp, pp = planes(twin)
    try:
        l0 = leases(jp, pp)
        bfs(*l0)
        ps0 = l0[1][0]
        cached = ps0._hybrid_csr_by_device[CPU]
        twin.add_edge(6, 7)
        lj, lp = leases(jp, pp)
        ps1, pv1, pi1 = lp
        assert ps1 is ps0                            # no republish
        assert ps0._hybrid_csr_by_device[CPU] is cached   # no re-upload
        assert pv1.count == 2 and pi1["epoch"] == 0
        assert pi1["applied_epoch"] == twin.g["port"].mutation_epoch
        d = bfs(lj, lp)
        assert np.array_equal(d, rebuilt_bfs(twin.g["port"]))
        same_stats(jp.stats(), pp.stats())
    finally:
        jp.close()
        pp.close()


def test_edge_removal_tombstones_then_compaction_folds(twin):
    jp, pp = planes(twin)
    try:
        _, (ps0, _, _) = leases(jp, pp)

        def remove(tx, ids):
            next(iter(tx.vertex(ids[0]).out_edges("link"))).remove()
        twin.commit(remove)
        lj, lp = leases(jp, pp)
        ps1, pv1, pi1 = lp
        assert ps1 is ps0 and pv1.tomb_count == 2     # both rows
        d = bfs(lj, lp)
        rebuilt = PS.build(twin.g["port"], directed=False)
        assert np.array_equal(d, rebuilt_bfs(twin.g["port"]))
        assert jp.compact_if_dirty() and pp.compact_if_dirty()
        lj2, lp2 = leases(jp, pp)
        ps2, pv2, pi2 = lp2
        assert ps2 is not ps1 and pv2.empty
        assert pi2["epoch"] == pi1["epoch"] + 1
        assert ps2.num_edges == rebuilt.num_edges
        assert np.array_equal(bfs(lj2, lp2), d)
        same_stats(jp.stats(), pp.stats())
    finally:
        jp.close()
        pp.close()


def test_vertex_change_triggers_compaction_republish(twin):
    """A vertex-set change takes the host path and then ``apply_changes``
    (ROADMAP queue 3, item 7: the port's algorithm is not JAX's); the
    republished snapshot is held to JAX's field by field."""
    jp, pp = planes(twin)
    try:
        _, (ps0, _, pi0) = leases(jp, pp)

        def grow(tx, ids):
            w = tx.add_vertex("node", name="v99")
            tx.vertex(ids[2]).add_edge("link", w)
        twin.commit(grow)
        lj, lp = leases(jp, pp)
        ps1, pv1, pi1 = lp
        assert ps1 is not ps0                        # republished
        assert pi1["epoch"] == pi0["epoch"] + 1 and pv1.empty
        fresh = PS.build(twin.g["port"], directed=False)
        assert ps1.n == fresh.n
        for f in ("vertex_ids", "src", "dst"):
            assert np.array_equal(getattr(ps1, f), getattr(fresh, f)), f
        policy = pp.stats()["compactor"]
        assert policy["merge_mode"] == "host" and policy["fallbacks"] == \
            {"apply-path": 1}
        same_stats(jp.stats(), pp.stats())
    finally:
        jp.close()
        pp.close()


def test_pool_retires_leased_base_on_republish(twin):
    jp, pp = planes(twin)
    jpool, ppool = JPool(live=jp), PPool(live=pp)
    try:
        jl, pl = jpool.acquire(), ppool.acquire()
        old = pl.snapshot
        same_snapshot(jl.snapshot, old)
        edges_before = old.num_edges
        assert pl.overlay is not None and pl.epoch_info == jl.epoch_info
        same_view(jl.overlay, pl.overlay)
        assert ppool.ready() == jpool.ready() == \
            (True, "live plane at epoch 0")
        # a vertex add: compaction, republish while the lease is out
        twin.commit(lambda tx, ids: tx.add_vertex("node", name="v98"))
        with jpool.acquire() as js2, ppool.acquire() as ps2:
            assert ps2 is not old
            same_snapshot(js2, ps2)
        assert ppool.stats() == jpool.stats()
        assert ppool.stats()["retired"] == 1
        assert ppool.stats()["live_epoch"] == 1
        assert old.num_edges == edges_before   # leased arrays untouched
        jl.release()
        pl.release()
        assert ppool.stats() == jpool.stats()
        assert ppool.stats()["retired"] == 0
        # another key goes through build and refresh
        with ppool.acquire(directed=True) as sd, \
                jpool.acquire(directed=True) as jd:
            same_snapshot(jd, sd)
            assert sd is not pp.snapshot
    finally:
        jpool.close()
        ppool.close()
        jp.close()
        pp.close()


def test_overlay_budget_compaction_and_metrics(twin):
    jp, pp = planes(twin, lax=False, max_fill=0.99, max_tomb_fraction=0.1)
    try:
        # removals push the tombstone fraction over 0.1: auto-compact
        def remove(tx, ids):
            for e in list(tx.vertex(ids[1]).out_edges("link")):
                e.remove()
        twin.commit(remove)
        _, (_, view, info) = leases(jp, pp)
        assert info["epoch"] >= 1 and view.empty
        st = pp.stats()
        assert st["counters"]["compactions"] >= 1
        assert st["counters"]["edges_tombstoned"] >= 1
        assert st["freshness"]["lag_epochs"] == 0
        assert st["apply_ms"]["count"] >= 1
        same_stats(jp.stats(), st)
    finally:
        jp.close()
        pp.close()


def same_result(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k, x in a.items():
        y = b[k]
        if isinstance(x, np.ndarray) and x.dtype.kind == "f":
            np.testing.assert_allclose(y, x, rtol=PAGERANK_RTOL)
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y), k
        else:
            assert x == y, k


def schedulers(jp, pp):
    js = JSCH.JobScheduler(live=jp, metrics=JM.MetricManager(),
                           hbm_budget_bytes=1e12)
    ps = PSCH.JobScheduler(live=pp, metrics=PM.MetricManager(),
                           hbm_budget_bytes=1e12, device="cpu")
    return js, ps


def run_both(scheds, kind: str, **params):
    """One job on each scheduler, waited for; both must end alike."""
    js, ps = scheds
    out = []
    for s, api in ((js, JA), (ps, PA)):
        j = s.submit(api.JobSpec(kind=kind, params=params))
        assert j.wait(WAIT), j
        assert j.state.value == "done", j.error
        out.append(j)
    jj, pj = out
    same_result(jj.result, pj.result)
    assert jj.ran_epoch == pj.ran_epoch
    return pj


def test_scheduler_jobs_under_writes_report_epoch(twin):
    jp, pp = planes(twin)
    scheds = schedulers(jp, pp)
    try:
        ids = twin.ids
        j1 = run_both(scheds, "bfs", source=ids[0])
        r1 = j1.result["reached"]
        twin.add_edge(6, 7)
        j2 = run_both(scheds, "bfs", source=ids[0])
        assert j2.result["reached"] == r1 + 1       # fresh, no rebuild
        assert j2.ran_epoch["seq"] > j1.ran_epoch["seq"] \
            or j2.ran_epoch["epoch"] > j1.ran_epoch["epoch"]
        assert "epoch" in j2.to_wire()
        # pagerank compacts before running (the dense fallback) and
        # still completes under the dirty overlay
        j3 = run_both(scheds, "pagerank", iterations=2)
        assert j3.ran_epoch["seq"] == 0             # compacted lease
        # wcc over the (possibly clean) overlay
        run_both(scheds, "wcc")
        same_stats(scheds[0].live_stats(), scheds[1].live_stats())
        # the served epoch is resident in the ledger and evictable
        assert id(pp.snapshot) in scheds[1]._evictable
    finally:
        for s in scheds:
            s.close()          # closes the plane too
    assert pp._closed and jp._closed


def test_live_stats_equal_jax(twin):
    """``GET /live`` is not ported (the server is item 8's front door):
    ``JobScheduler.live_stats()``, what it serves, equals JAX's."""
    jp, pp = planes(twin)
    scheds = schedulers(jp, pp)
    try:
        assert scheds[1]._dump_config()["live"] is \
            scheds[0]._dump_config()["live"] is True
        twin.add_edge(3, 8)
        jp.pump()
        pp.pump()
        sj, sp = scheds[0].live_stats(), scheds[1].live_stats()
        assert sp["overlay"]["adds"] == 2
        for key in ("freshness", "counters", "apply_ms", "compact_ms"):
            assert key in sp
        assert sp["freshness"]["lag_epochs"] == 0
        same_stats(sj, sp)
    finally:
        for s in scheds:
            s.close()


def test_plane_background_pump_and_concurrent_writers(twin):
    """Writers commit while the pump ingests in the background; the final
    lease converges to the rebuilt truth. The same edges committed in one
    order on the JAX twin give the same BFS rows."""
    pp = PL.LiveGraphPlane(twin.g["port"], metrics=PM.MetricManager(),
                           compactor=PL.EpochCompactor(0.99, 0.99,
                                                       device="cpu"),
                           poll_interval_s=0.01, device="cpu")
    errors: list = []
    ids = twin.ids
    pairs = {k: [tuple(int(x) for x in np.random.default_rng(k).choice(
        len(ids), 2, replace=False)) for _ in range(8)] for k in range(3)}

    def writer(k):
        try:
            g = twin.g["port"]
            for a, b in pairs[k]:
                tx = g.new_transaction()
                tx.vertex(ids[a]).add_edge("link", tx.vertex(ids[b]))
                tx.commit()
        except Exception as e:     # pragma: no cover - fail loud
            errors.append(repr(e))

    try:
        ts = [threading.Thread(target=writer, args=(k,)) for k in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not errors, errors
        snap, view, info = pp.lease_state()
        assert info["applied_epoch"] == twin.g["port"].mutation_epoch
        srcs = list(range(10))
        d_ov, _, _ = P.frontier_bfs_batched(snap, srcs, overlay=view,
                                            device="cpu")
        assert np.array_equal(d_ov, rebuilt_bfs(twin.g["port"], srcs))
        gj = twin.g["jax"]
        for k in range(3):
            for a, b in pairs[k]:
                tx = gj.new_transaction()
                tx.vertex(ids[a]).add_edge("link", tx.vertex(ids[b]))
                tx.commit()
        d_j, _, _ = H.frontier_bfs_batched(JS.build(gj, directed=False),
                                           srcs)
        assert np.array_equal(np.asarray(d_j), d_ov)
    finally:
        pp.close()
    assert not pp._thread.is_alive()


def test_resync_on_listener_overflow_reanchors(twin):
    """Listener overflow: a full re-scan; the same queue accumulates
    again afterwards, so the next delta takes the overlay path."""
    jp, pp = planes(twin)
    try:
        jp._queue.overflowed = True          # a backlog past the cap
        pp._queue.overflowed = True
        twin.add_edge(0, 9)                  # dropped by the dead queue
        _, (ps1, pv1, pi1) = leases(jp, pp)
        assert pi1["epoch"] >= 1 and pv1.empty          # resynced
        assert pp.stats()["counters"]["resyncs"] == 1
        assert not pp._queue.overflowed                 # re-anchored
        twin.add_edge(1, 8)
        _, (ps2, pv2, _) = leases(jp, pp)
        assert ps2 is ps1 and pv2.count == 2
        assert pp.stats()["counters"]["resyncs"] == 1   # no new scan
        same_stats(jp.stats(), pp.stats())
    finally:
        jp.close()
        pp.close()


def test_a_local_delta_gap_resyncs_like_jax(twin):
    """A payload missing from the queue (the epoch it covers never
    arrives) is the local lane's gap: a resync, as in JAX."""
    jp, pp = planes(twin)
    try:
        twin.add_edge(2, 9)
        jp._queue.clear()
        pp._queue.clear()
        _, (_, pv, pi) = leases(jp, pp)
        assert pi["epoch"] == 1 and pv.empty
        assert pp.stats()["counters"]["resyncs"] == 1
        same_stats(jp.stats(), pp.stats())
    finally:
        jp.close()
        pp.close()


class _Ledger:
    """A ledger that refuses the overlay's growth past ``limit`` bytes and
    logs every call (duck-typed as the overlay and compactor use it)."""

    def __init__(self, limit: int):
        self.limit, self.log = limit, []

    def reserve(self, key, nbytes):
        self.log.append(("reserve", key[0] if isinstance(key, tuple)
                         else "snap", nbytes))
        if isinstance(key, tuple) and key[0] == "live-overlay" \
                and nbytes > self.limit:
            raise RuntimeError("admission refused")

    def release(self, key):
        self.log.append(("release", key[0] if isinstance(key, tuple)
                         else "snap"))

    def unpin(self, key):
        self.log.append(("unpin", key[0] if isinstance(key, tuple)
                         else "snap"))


def test_append_retries_after_an_hbm_admission_failure(twin):
    """The overlay's growth refused by the ledger: a compaction
    (``why="hbm admission"``) frees the overlay and the append is retried
    once against the fresh minimum-capacity buffer."""
    jp, pp = planes(twin, min_cap=4)
    try:
        leases(jp, pp)
        # the first overlay was built before a ledger was lent: give both
        # a fresh one that reserves through a ledger refusing any growth
        for p in (jp, pp):
            p._ledger = _Ledger(1 << 30)
            p.overlay.close()
            p.overlay = p._new_overlay(p.snapshot)
            p._ledger.limit = p.overlay.device_bytes() + 16
        twin.add_edge(6, 7)                  # 2 rows of the 4
        _, (_, pv, pi) = leases(jp, pp)
        assert pi["epoch"] == 0 and pv.count == 2

        def two(tx, ids):
            for a, b in ((7, 8), (8, 9)):
                tx.vertex(ids[a]).add_edge("link", tx.vertex(ids[b]))
        twin.commit(two)                     # 4 more rows: a growth
        _, (_, pv, pi) = leases(jp, pp)
        # the refused growth compacted; the retry filled the fresh buffer,
        # which the budget then folded too
        assert pi["epoch"] == 2 and pv.empty
        assert pp.stats()["counters"]["compactions"] == 2
        assert jp._ledger.log == pp._ledger.log
        assert ("reserve", "live-overlay", pp.overlay.device_bytes()) \
            in pp._ledger.log
        same_stats(jp.stats(), pp.stats())
        d = bfs(jp.lease_state(), pp.lease_state(), range(10))
        assert np.array_equal(d, rebuilt_bfs(twin.g["port"], range(10)))
    finally:
        jp.close()
        pp.close()


# -- the plane tests of tests/test_live_compact_device.py ------------------

def test_plane_publishes_device_merged_epoch(twin):
    jp, pp = planes(twin, lax=False, min_cap=4, max_fill=0.5)
    try:
        (js0, _, _), (ps0, _, _) = leases(jp, pp)
        H.build_chunked_csr(js0)
        P.build_chunked_csr(ps0, "cpu")     # the base resident on the device
        twin.add_edge(6, 7)
        twin.add_edge(7, 8)
        (js1, _, _), (ps1, _, _) = leases(jp, pp)
        st = pp.stats()
        assert st["epoch"] == 1 and ps1 is not ps0
        assert st["compactor"]["merge_mode"] == "device"
        assert st["compactor"]["device_merges"] == 1
        assert st["counters"]["device_merge_fallbacks"] == 0
        # the new epoch arrives with its CSR attached: the next run
        # uploads nothing
        got = ps1._hybrid_csr_by_device[CPU]
        rebuilt = PS.build(twin.g["port"], directed=False)
        want = P.build_chunked_csr(rebuilt, "cpu")
        jg = js1._hybrid_csr
        assert got["q_total"] == want["q_total"] == jg["q_total"]
        for k in ("dstT", "colstart", "degc", "deg"):
            assert torch.equal(got[k], want[k]), k
            assert np.array_equal(got[k].numpy(), np.asarray(jg[k])), k
        for attr in ("src", "dst", "indptr_in", "out_degree"):
            assert np.array_equal(getattr(ps1, attr),
                                  getattr(rebuilt, attr)), attr
        # only delta pages crossed to the device
        up = st["counters"]["upload_bytes"]
        assert 0 < up < snapshot_csr_bytes(rebuilt)
        assert st["compact_device_ms"]["count"] == 1
        same_stats(jp.stats(), st)
    finally:
        jp.close()
        pp.close()


def test_plane_policy_is_configuration_not_module_constants(twin):
    jp, pp = planes(twin, lax=False, max_fill=0.25,
                    max_tomb_fraction=0.125, device_merge=False)
    try:
        pol = pp.stats()["compactor"]
        assert pol["max_fill"] == 0.25
        assert pol["max_tomb_fraction"] == 0.125
        assert pol["device_merge"] is False
        assert pp.compactor.max_fill == 0.25
        assert pol == jp.stats()["compactor"]
    finally:
        jp.close()
        pp.close()


def test_plane_host_mode_when_device_disabled(twin):
    jp, pp = planes(twin, lax=False, min_cap=4, max_fill=0.5,
                    device_merge=False)
    try:
        (js0, _, _), (ps0, _, _) = leases(jp, pp)
        H.build_chunked_csr(js0)
        P.build_chunked_csr(ps0, "cpu")
        twin.add_edge(6, 7)
        twin.add_edge(7, 8)
        _, (ps1, _, _) = leases(jp, pp)
        st = pp.stats()
        assert st["epoch"] == 1
        assert st["compactor"]["merge_mode"] == "host"
        # the host path leaves no device CSR and charges the whole
        # re-upload to the byte counter
        assert not getattr(ps1, "_hybrid_csr_by_device", None)
        assert st["counters"]["upload_bytes"] >= snapshot_csr_bytes(ps1)
        same_stats(jp.stats(), st)
    finally:
        jp.close()
        pp.close()


# -- the port's own: devices --------------------------------------------

def test_device_none_means_cuda(twin, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PL.LiveGraphPlane(twin.g["port"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PL.EpochCompactor()
    pp = PL.LiveGraphPlane(twin.g["port"], device="cpu")
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PSCH.JobScheduler(live=pp)
    finally:
        pp.close()


def test_a_plane_on_another_device_is_refused(twin):
    """Work never moves between devices silently: a compactor or a
    scheduler on another device than the plane's raises ValueError."""
    with pytest.raises(ValueError, match="merges on meta"):
        PL.LiveGraphPlane(twin.g["port"], device="cpu",
                          compactor=PL.EpochCompactor(device="meta"))
    pp = PL.LiveGraphPlane(twin.g["port"], device="cpu")
    try:
        with pytest.raises(ValueError, match="serves on cpu"):
            PSCH.JobScheduler(live=pp, device="meta")
        assert pp.overlay.device == CPU
        assert pp.compactor.device == CPU
    finally:
        pp.close()
