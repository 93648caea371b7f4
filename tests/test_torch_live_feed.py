"""The port's change feed (titan_tpu_torch/olap/live/feed.py) and the live
plane's feed lane, over the port's ``sqlite`` store, held to the JAX
package's (tests/test_live_feed.py has the JAX package's own tests, which
these mirror).

Two graph handles over one sqlite directory, with distinct
``graph.unique-instance-id``s, behave like two cluster nodes: the feed on
handle ``a`` sees handle ``b``'s tagged commits through the durable
``ulog_*`` log, resumable by its named read marker. Each package gets its
own directory; the two packages' handles run the same seeded operations
(``SimpleBulkPlacement`` seeded on the handle that makes the vertices), so
vertex ids agree. Payloads are compared by content: under no WAL the
trigger log's tags are commit timestamps, which differ between runs."""

import time

import numpy as np
import pytest

import titan_tpu
import titan_tpu.olap.api as JA
import titan_tpu.olap.serving.scheduler as JSCH
import titan_tpu.utils.metrics as JM
import titan_tpu_torch
import titan_tpu_torch.olap.api as PA
import titan_tpu_torch.olap.serving.scheduler as PSCH
import titan_tpu_torch.utils.metrics as PM
from titan_tpu.core.changes import ChangeState as JChangeState
from titan_tpu.ids.placement import SimpleBulkPlacement as JPlace
from titan_tpu.olap import live as JL
from titan_tpu.olap.live.feed import DeltaBatch as JDeltaBatch
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu_torch.core.changes import ChangeState
from titan_tpu_torch.ids.placement import SimpleBulkPlacement as PPlace
from titan_tpu_torch.models import bfs_hybrid as P
from titan_tpu_torch.olap import live as PL
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.live.feed import ChangeFeed, DeltaBatch

PKGS = {"jax": (titan_tpu, JPlace), "port": (titan_tpu_torch, PPlace)}
FIELDS = ("n", "vertex_ids", "src", "dst", "indptr_in", "out_degree",
          "labels", "label_names", "epoch")
WAIT = 120


def _open(which, shared_dir, instance, seed=None):
    pkg, place = PKGS[which]
    g = pkg.open({"storage.backend": "sqlite",
                  "storage.directory": shared_dir,
                  "graph.unique-instance-id": instance})
    if seed is not None:
        g.id_assigner.placement = place(g.idm.num_partitions,
                                        batch_size=4, seed=seed)
    return g


@pytest.fixture
def pair(tmp_path):
    """For each package, two handles ``a`` and ``b`` over its own sqlite
    directory; closed at the end."""
    out = {}
    for which in PKGS:
        d = str(tmp_path / which)
        out[which] = (_open(which, d, "a", seed=7), _open(which, d, "b"))
    yield out
    for g1, g2 in out.values():
        g1.close()
        g2.close()


def _wait_for(pred, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _vertices(g, k: int) -> list:
    tx = g.new_transaction()
    vs = [tx.add_vertex("node", name=f"v{i}") for i in range(k)]
    tx.commit()
    return [v.id for v in vs]


def _tagged_edge(g, ident: str, a: int, b: int) -> None:
    tx = g.new_transaction(log_identifier=ident)
    tx.vertex(a).add_edge("link", tx.vertex(b))
    tx.commit()


def same_snapshot(js, ps) -> None:
    for f in FIELDS:
        a, b = getattr(js, f), getattr(ps, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


def same_batch(jb, pb) -> None:
    for f in ("seq", "txid", "timestamp", "sender", "add_type", "del_type",
              "prop_keys"):
        assert getattr(jb, f) == getattr(pb, f), f
    for f in ("add_out", "add_in", "del_out", "del_in", "vtx_add",
              "vtx_del"):
        a, b = getattr(jb, f), getattr(pb, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert jb.empty == pb.empty
    assert jb.to_payload() == pb.to_payload()


def content(batch) -> dict:
    """A batch's payload without its tag and commit time."""
    p = batch.to_payload()
    del p["txid"], p["time"]
    return p


PAYLOADS = [
    {"txid": 9, "time": 123, "added_vertices": [5], "removed_vertices": [6],
     "added": [{"type": "knows", "out": 1, "in": 2},
               {"type": "name", "out": 1, "value": "x"}],
     "removed": [{"type": "knows", "out": 3, "in": 4}]},
    {"txid": 1, "time": 2, "added_vertices": [], "removed_vertices": [],
     "added": [], "removed": []},
    {"txid": 3, "time": 4, "added_vertices": [], "removed_vertices": [7, 8],
     "added": [{"type": "a", "out": 1 << 40, "in": 2},
               {"type": "b", "out": 3, "in": 4},
               {"type": "age", "out": 3, "value": 7}],
     "removed": [{"type": "tag", "out": 5, "value": "t"}]}]


@pytest.mark.parametrize("payload", PAYLOADS, ids=["mixed", "empty",
                                                   "props"])
def test_delta_batch_columnar_roundtrip(payload):
    b = DeltaBatch.from_state(1, ChangeState(payload, sender=b"w1"))
    same_batch(JDeltaBatch.from_state(1, JChangeState(payload,
                                                      sender=b"w1")), b)
    if payload["txid"] != 9:
        return
    assert b.seq == 1 and b.txid == 9 and b.sender == b"w1"
    assert b.add_out.tolist() == [1] and b.add_in.tolist() == [2]
    assert b.add_type == ["knows"]
    assert b.del_out.tolist() == [3] and b.del_in.tolist() == [4]
    assert b.vtx_add.tolist() == [5] and b.vtx_del.tolist() == [6]
    assert b.prop_keys == {"name"}
    back = b.to_payload()
    assert back["added"][0] == {"type": "knows", "out": 1, "in": 2}
    assert back["removed"] == [{"type": "knows", "out": 3, "in": 4}]
    assert back["added_vertices"] == [5]
    # property mutations survive as relations without "in" (the
    # apply_changes column-invalidation shape)
    assert any("in" not in r and r["type"] == "name"
               for r in back["added"])


def test_cross_instance_feed_and_drain_into_snapshot(pair):
    """Handle b's tagged commits reach a snapshot built on handle a
    through the durable log and ``apply_changes``: the same arrays as a
    full rebuild, and as the JAX package's drained snapshot."""
    snaps, stats = {}, {}
    for which, (g1, g2) in pair.items():
        feed_cls = ChangeFeed if which == "port" else JL.ChangeFeed
        smod = PS if which == "port" else JS
        tx = g1.new_transaction()
        vs = [tx.add_vertex("node", name=f"v{i}") for i in range(6)]
        for a, b in [(0, 1), (1, 2), (2, 3)]:
            vs[a].add_edge("link", vs[b])
        tx.commit()
        ids = [v.id for v in vs]
        snap = smod.build(g1)
        feed = feed_cls(g1, "live", read_interval_ms=20)
        _tagged_edge(g2, "live", ids[3], ids[4])
        tx3 = g2.new_transaction(log_identifier="live")
        next(iter(tx3.vertex(ids[0]).out_edges("link"))).remove()
        tx3.commit()
        assert _wait_for(lambda: feed.pending() >= 2), feed.pending()
        stats[which] = feed.drain_into(snap, g1.schema, g1.idm)
        fresh = smod.build(g1)
        same_snapshot(fresh, snap)
        snaps[which] = snap
        feed.close()
    assert stats["port"] == stats["jax"]
    assert stats["port"]["batches"] == 2
    assert stats["port"]["added_edges"] == 1
    assert stats["port"]["removed_edges"] == 1
    same_snapshot(snaps["jax"], snaps["port"])


def test_feed_skips_own_instance_messages(pair):
    """Local tagged commits arrive through the in-process listener: the
    feed drops its own rid's log messages, or the plane would apply them
    twice."""
    got = {}
    for which, (g1, g2) in pair.items():
        feed_cls = ChangeFeed if which == "port" else JL.ChangeFeed
        v1, v2 = _vertices(g1, 2)
        feed = feed_cls(g1, "own", read_interval_ms=20)
        _tagged_edge(g1, "own", v1, v2)       # logged, dropped by sender
        _tagged_edge(g2, "own", v2, v1)       # kept
        assert _wait_for(lambda: feed.pending() >= 1)
        time.sleep(0.2)
        batches = feed.poll()
        assert len(batches) == 1
        assert batches[0].sender == b"b"
        got[which] = content(batches[0])
        # b"" keeps everything, the own commit included
        feed2 = feed_cls(g1, "own", read_interval_ms=20, skip_sender=b"",
                         start_time=0)
        assert _wait_for(lambda: feed2.pending() >= 2)
        assert sorted(b.sender for b in feed2.poll()) == [b"a", b"b"]
        feed.close()
        feed2.close()
    assert got["jax"] == got["port"]


def test_feed_resumes_from_named_marker(pair):
    """A restarted feed with the same reader_id continues from its
    durable cursor: no replay of batches already consumed."""
    for which, (g1, g2) in pair.items():
        feed_cls = ChangeFeed if which == "port" else JL.ChangeFeed
        va, vb = _vertices(g1, 2)
        feed1 = feed_cls(g1, "mk", reader_id="r1", read_interval_ms=20)
        _tagged_edge(g2, "mk", va, vb)
        assert _wait_for(lambda: feed1.pending() >= 1)
        got1 = feed1.poll()
        assert len(got1) == 1
        # let the reader thread persist the cursor, then restart
        time.sleep(0.3)
        feed1.close()
        feed2 = feed_cls(g1, "mk", reader_id="r1", read_interval_ms=20)
        _tagged_edge(g2, "mk", vb, va)
        assert _wait_for(lambda: feed2.pending() >= 1)
        time.sleep(0.2)
        got2 = feed2.poll()
        # only the new commit: the marker (and the dedup watermark) keep
        # the consumed one from replaying
        assert len(got2) == 1, which
        assert got2[0].txid != got1[0].txid \
            or got2[0].timestamp != got1[0].timestamp
        assert content(got2[0])["added"][0]["out"] == vb
        feed2.close()


def test_feed_watermark_drops_a_redelivered_message(pair):
    """Delivery is at least once; the per-sender ``(timestamp, txid)``
    watermark drops what it has seen."""
    g1, _ = pair["port"]
    feed = ChangeFeed(g1, "dup", start_time=None)
    payload = {"txid": 5, "time": 50, "added_vertices": [],
               "removed_vertices": [], "added": [], "removed": []}
    for t in (50, 50, 49, 51):
        p = dict(payload, time=t)
        feed._on_state(g1, 5, ChangeState(p, sender=b"x"))
    feed._on_state(g1, 5, ChangeState(payload, sender=b"y"))
    assert [(b.sender, b.timestamp) for b in feed.poll()] == \
        [(b"x", 50), (b"x", 51), (b"y", 50)]
    assert feed._watermarks == {b"x": (51, 5), b"y": (50, 5)}
    assert feed.lag_seconds() == 0.0
    feed.close()


def test_feed_backpressure_blocks_ingest(pair):
    """Past the high watermark the log reader blocks (the durable cursor
    stops, nothing is lost) and the backpressure counter ticks; a poll()
    drains and resumes ingest."""
    for which, (g1, g2) in pair.items():
        feed_cls = ChangeFeed if which == "port" else JL.ChangeFeed
        metrics = PM.MetricManager() if which == "port" \
            else JM.MetricManager()
        va, vb = _vertices(g1, 2)
        feed = feed_cls(g1, "bp", read_interval_ms=20, high_watermark=2,
                        low_watermark=1, metrics=metrics)
        for _ in range(4):
            _tagged_edge(g2, "bp", va, vb)
        assert _wait_for(lambda: metrics.counter_value(
            "serving.live.backpressure") >= 1)
        assert feed.pending() <= 3     # high + the one that blocked
        seen = [0]

        def drained():
            seen[0] += len(feed.poll())
            return seen[0] >= 4

        assert _wait_for(drained), seen
        assert metrics.counter_value("serving.live.feed_batches") == 4
        feed.close()


# -- the plane's feed lane -------------------------------------------------

def _plane(which, g, **kw):
    if which == "port":
        return PL.LiveGraphPlane(g, metrics=PM.MetricManager(),
                                 device="cpu", **kw)
    return JL.LiveGraphPlane(g, metrics=JM.MetricManager(), **kw)


def _serve_bfs(which, plane, source: int):
    if which == "port":
        sched = PSCH.JobScheduler(live=plane, metrics=PM.MetricManager(),
                                  hbm_budget_bytes=1e12, device="cpu")
        api = PA
    else:
        sched = JSCH.JobScheduler(live=plane, metrics=JM.MetricManager(),
                                  hbm_budget_bytes=1e12)
        api = JA
    try:
        j = sched.submit(api.JobSpec(kind="bfs",
                                     params={"source": source}))
        assert j.wait(WAIT) and j.state.value == "done", j.error
        return j
    finally:
        sched.close()


def test_the_plane_serves_a_second_handles_commits(pair):
    """The cross-instance lane: handle b's tagged commits reach a BFS
    served over handle a's plane through the feed; a's own tagged commit
    arrives once, through the in-process listener."""
    out = {}
    for which, (g1, g2) in pair.items():
        ids = _vertices(g1, 8)
        plane = _plane(which, g1, log_identifier="live")
        try:
            _tagged_edge(g2, "live", ids[0], ids[1])
            _tagged_edge(g2, "live", ids[1], ids[2])
            _tagged_edge(g1, "live", ids[2], ids[3])    # the plane's own

            def arrived():
                plane.pump()
                return plane.overlay.count >= 6
            assert _wait_for(arrived), plane.stats()
            time.sleep(0.3)
            plane.pump()
            assert plane.overlay.count == 6            # nothing twice
            assert plane.feed.pending() == 0
            st = plane.stats()
            assert st["counters"]["feed_batches"] == 2
            assert st["freshness"]["lag_epochs"] == 0
            j = _serve_bfs(which, plane, ids[0])
            assert j.result["reached"] == 4
            out[which] = (j.result, j.ran_epoch, st["overlay"])
        finally:
            plane.close()
    (rj, ej, oj), (rp, ep, op) = out["jax"], out["port"]
    assert rj.keys() == rp.keys()
    assert np.array_equal(rj["dist"], rp["dist"])
    assert rj["reached"] == rp["reached"] and ej == ep and oj == op


def test_a_feed_seq_gap_resyncs(pair):
    """A batch missing from the feed's sequence: the plane drops the rest
    of that poll and rescans the store, as the JAX plane does."""
    out = {}
    for which, (g1, g2) in pair.items():
        ids = _vertices(g1, 4)
        plane = _plane(which, g1, log_identifier="gap")
        try:
            plane.feed._seq += 1                        # a lost batch
            _tagged_edge(g2, "gap", ids[0], ids[1])

            def resynced():
                plane.pump()
                return plane.stats()["counters"]["resyncs"] == 1
            assert _wait_for(resynced), plane.stats()
            snap, view, info = plane.lease_state()
            assert info["epoch"] == 1 and view.empty
            assert snap.num_edges == 2                  # in the rescan
            out[which] = snap
        finally:
            plane.close()
    same_snapshot(out["jax"], out["port"])
    snap = out["port"]
    d = P.frontier_bfs_batched(snap, [snap.dense_of(ids[0])],
                               device="cpu")[0]
    assert (d < (1 << 30)).sum() == 2


def test_batches_older_than_the_ingest_floor_are_skipped(pair):
    """The feed starts before the build scan, so a batch committed before
    the floor is already in the base and is not applied again."""
    g1, g2 = pair["port"]
    ids = _vertices(g1, 4)
    plane = _plane("port", g1, log_identifier="floor")
    try:
        plane._ingest_floor = g1.backend.times.time() + 10 ** 12
        _tagged_edge(g2, "floor", ids[0], ids[1])
        assert _wait_for(lambda: (plane.pump(),
                                  plane._feed_seq == 1)[1])
        assert plane.overlay.count == 0
        assert plane.stats()["counters"]["deltas_applied"] == 0
    finally:
        plane.close()
