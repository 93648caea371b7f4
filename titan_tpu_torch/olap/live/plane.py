"""LiveGraphPlane: serve OLAP under writes without rebuilds or re-uploads
(the port's copy of ``titan_tpu/olap/live/plane.py``).

The orchestration layer over the three live primitives (feed.py /
overlay.py / compactor.py): one base ``GraphSnapshot`` whose device CSR
stays resident, one :class:`DeltaOverlay` absorbing committed deltas,
and an :class:`EpochCompactor` that folds the overlay into a republished
base when it crosses budget. Ingest has two lanes, unified on the
``change_payload`` shape:

* **local** — the base snapshot's atomically-subscribed in-process
  change queue (adopted from ``build()``), drained with the same
  epoch-continuity discipline as ``GraphSnapshot.refresh()``;
* **cross-instance** — a :class:`ChangeFeed` tailing the durable user
  trigger log (writers tag transactions with ``log_identifier`` — the
  TitanBus contract); the feed drops this instance's own messages and
  enforces seq continuity.

Epoch/lease contract: ``lease_state()`` returns ``(snapshot,
OverlayView, epoch_info)`` captured under one lock — a consistent pair.
``epoch_info`` carries the compaction ``epoch``, the overlay delta
``seq`` and the applied local mutation epoch; jobs report it so results
are attributable to an exact graph state. Deltas the overlay cannot
express (vertex adds/removals, edges to unknown vertices) trigger an
immediate compaction whose merged snapshot takes the general
``apply_changes`` path; listener overflow or a feed gap triggers a full
store re-scan (``resync``) that re-anchors the change queue.

Metrics (``serving.live.*`` — see docs/monitoring.md): deltas_applied,
edges_added, edges_tombstoned, compactions, resyncs, feed_batches,
backpressure, upload_bytes, download_bytes, device_merge_fallbacks
counters; apply_ms / compact_ms / compact_device_ms histograms;
freshness lag (epochs + seconds), overlay fill and tombstone fraction,
and the active compaction policy + merge mode via ``stats()`` →
``GET /live``.

Device: the plane's overlay views and its compactor's device merge lie
on ``device`` (``None`` means CUDA, and raises without a card; tests
pass ``"cpu"``). A prebuilt ``compactor`` must merge on the same device.
The base snapshot's chunked CSR is cached for that device by the first
served run (``_hybrid_csr_by_device``), which is what the device merge
reads.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from titan_tpu_torch.device import cache_key, resolve_device
from titan_tpu_torch.olap.live.compactor import EpochCompactor
from titan_tpu_torch.olap.live.feed import ChangeFeed
from titan_tpu_torch.olap.live.overlay import MIN_CAP, DeltaOverlay
from titan_tpu_torch.utils.metrics import MetricManager


#: the plane's ``serving.live.*`` counter family, one definition read by
#: stats(). upload_bytes / download_bytes / device_merge_fallbacks are
#: the byte accounting: delta pages + host-merge re-upload charges,
#: verify-mode readback, and loud device→host degrades.
_LIVE_COUNTERS = ("deltas_applied", "edges_added", "edges_tombstoned",
                  "compactions", "resyncs", "feed_batches",
                  "backpressure", "upload_bytes", "download_bytes",
                  "device_merge_fallbacks")


class LiveGraphPlane:
    """See module doc. One plane serves one snapshot parameter set
    (``labels`` + ``directed``; extracted edge_keys are unsupported —
    change payloads carry no edge property values)."""

    def __init__(self, graph, *, labels=None, directed: bool = False,
                 log_identifier: Optional[str] = None,
                 feed: Optional[ChangeFeed] = None,
                 reader_id: Optional[str] = None,
                 min_cap: int = MIN_CAP,
                 compactor: Optional[EpochCompactor] = None,
                 max_fill: Optional[float] = None,
                 max_tomb_fraction: Optional[float] = None,
                 device_merge: bool = True,
                 verify_device: bool = False,
                 ledger=None,
                 metrics: Optional[MetricManager] = None,
                 poll_interval_s: Optional[float] = None,
                 device=None):
        from titan_tpu_torch.olap.live.compactor import (
            MAX_FILL, MAX_TOMB_FRACTION)
        from titan_tpu_torch.olap import snapshot as snap_mod

        self.graph = graph
        self.device = resolve_device(device)
        self.labels = tuple(labels) if labels is not None else None
        self.directed = bool(directed)
        self._metrics = metrics or MetricManager.instance()
        # obs seam: the owning JobScheduler lends its tracer (like the
        # ledger) so apply/compaction epochs land on the reserved
        # "live" trace id; None = no tracing
        self._tracer = None
        # serving seam: the owning JobScheduler registers published
        # epochs in its HBM eviction map through this hook
        self._on_resident = None
        self._lock = threading.RLock()
        self._min_cap = int(min_cap)
        self._ledger = ledger
        # compaction policy is plane/server configuration, not module
        # constants: pass a prebuilt compactor OR the individual knobs
        self.compactor = compactor or EpochCompactor(
            max_fill if max_fill is not None else MAX_FILL,
            max_tomb_fraction if max_tomb_fraction is not None
            else MAX_TOMB_FRACTION,
            device_merge=device_merge, verify_device=verify_device,
            device=self.device)
        if self.compactor.device != cache_key(self.device):
            raise ValueError(
                f"the compactor merges on {self.compactor.device}, the "
                f"plane serves on {self.device}")

        # the feed starts BEFORE the build scan and the ingest floor is
        # stamped before it too: a remote commit racing the scan is
        # never LOST (at-least-once — it may duplicate a parallel edge
        # in the window, harmless to reachability-class results and
        # resolved by the next resync; exactly-once would need txid
        # bookkeeping in the scan, future work)
        self.feed = feed
        if self.feed is None and log_identifier is not None:
            self.feed = ChangeFeed(graph, log_identifier,
                                   reader_id=reader_id,
                                   start_time=None,
                                   metrics=self._metrics)
        self._feed_seq = 0
        self._ingest_floor = graph.backend.times.time()

        snap = snap_mod.build(graph, labels=labels, directed=directed)
        # adopt the snapshot's atomically-subscribed listener as the
        # plane's local ingest queue; published snapshots are plain
        # array objects (the plane owns freshness, not refresh())
        self._queue = snap._listener
        self._token = snap._listener_token
        self.applied_epoch = snap.epoch
        self._label_ids = (snap._build_params or {}).get("label_ids")
        self._detach(snap)
        self.snapshot = snap
        self.overlay = self._new_overlay(snap)
        self.epoch = 0                 # compaction epoch
        self._republish = None         # pool hook: fn(old, new)
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        if poll_interval_s is not None:
            self.start(poll_interval_s)

    # -- plumbing ------------------------------------------------------------

    @staticmethod
    def _detach(snap) -> None:
        """Published snapshots must not own the plane's listener: their
        close() (pool retirement) would unsubscribe the queue the plane
        keeps draining."""
        snap._graph = None
        snap._listener = None
        snap._listener_token = 0

    def _new_overlay(self, snap) -> DeltaOverlay:
        return DeltaOverlay(snap, min_cap=self._min_cap,
                            ledger=self._ledger,
                            ledger_key=("live-overlay", id(self)),
                            metrics=self._metrics, device=self.device)

    @property
    def pool_key(self) -> tuple:
        from titan_tpu_torch.olap.serving.pool import SnapshotPool
        return SnapshotPool.key_of(self.labels, (), self.directed)

    def start(self, poll_interval_s: float = 0.05) -> "LiveGraphPlane":
        """Background pump so freshness does not depend on lease
        traffic."""
        if self._thread is not None and self._thread.is_alive():
            return self

        def loop():
            while not self._closed:
                try:
                    self.pump()
                except Exception:
                    pass               # next tick retries; pump states
                self._wake.wait(poll_interval_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="live-plane-pump")
        self._thread.start()
        return self

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        if self.feed is not None:
            self.feed.close()
        self.overlay.close()
        self.graph.unsubscribe_changes(self._token)

    # -- ingest --------------------------------------------------------------

    def pump(self) -> None:
        """Drain both ingest lanes into the overlay (or through a
        compaction). Idempotent, cheap when idle; called by the
        background loop and on every lease."""
        with self._lock:
            if self._closed:
                return
            self._pump_local()
            self._pump_feed()

    def _pump_local(self) -> None:
        g, q = self.graph, self._queue
        if q.overflowed:
            self._resync("listener overflow")
            return
        new_epoch = g.mutation_epoch
        if new_epoch == self.applied_epoch:
            return
        # same drain discipline as GraphSnapshot.refresh(): scan-then-
        # slice up to new_epoch; racing payloads stay queued
        cut = 0
        while cut < len(q) and (q[cut].get("epoch") is None
                                or q[cut]["epoch"] <= new_epoch):
            cut += 1
        pending = list(q[:cut])
        del q[:cut]
        covered = [e for e in (p.get("epoch") for p in pending)
                   if e is not None
                   and self.applied_epoch < e <= new_epoch]
        if len(covered) != new_epoch - self.applied_epoch:
            self._resync("local delta gap")
            return
        self._apply_payloads(
            [p for p in pending
             if p.get("epoch") is None
             or p["epoch"] > self.applied_epoch])
        self.applied_epoch = new_epoch

    def _pump_feed(self) -> None:
        if self.feed is None:
            return
        batches = self.feed.poll()
        if not batches:
            return
        for batch in batches:
            if batch.seq != self._feed_seq + 1:
                # continuity broke: the store re-scan covers every
                # committed batch, so the rest of this poll is dropped
                # (applying it on top would double-apply)
                self._feed_seq = batches[-1].seq
                self._resync(f"feed seq gap (expected "
                             f"{self._feed_seq + 1})")
                return
            self._feed_seq = batch.seq
            if batch.timestamp <= self._ingest_floor:
                continue               # covered by the base build scan
            self._apply_payloads([batch.to_payload()])

    # -- delta application ---------------------------------------------------

    def _resolve(self, name: str):
        """Edge/property type by name; remote writers may have created
        it after our schema cache warmed — expire once and retry."""
        st = self.graph.schema.get_by_name(name)
        if st is None:
            try:
                self.graph.schema.expire()
            except Exception:
                return None
            st = self.graph.schema.get_by_name(name)
        return st

    def _payload_fits_overlay(self, p: dict) -> bool:
        if p.get("added_vertices") or p.get("removed_vertices"):
            return False
        idm = self.graph.idm
        vids = self.snapshot.vertex_ids
        for r in p.get("added", ()):
            if "in" not in r:
                continue
            st = self._resolve(r["type"])
            if st is None or (self._label_ids is not None
                              and st.id not in self._label_ids):
                continue
            for vid in (r["out"], r["in"]):
                cv = idm.canonical_vertex_id(vid)
                i = int(np.searchsorted(vids, cv))
                if i >= len(vids) or vids[i] != cv:
                    return False       # edge to an unknown vertex
        return True

    def _apply_payloads(self, payloads: list) -> None:
        if not payloads:
            return
        for i, p in enumerate(payloads):
            if not self._payload_fits_overlay(p):
                # flush what the overlay can absorb, then fold the rest
                # through the merged snapshot's general apply path
                self._overlay_apply(payloads[:i])
                self._compact(payloads[i:], why="vertex-set change")
                return
        self._overlay_apply(payloads)
        if self.compactor.should_compact(self.overlay):
            self._compact([], why="budget")

    def _append(self, a_s, a_d, a_l) -> int:
        """Overlay append with the HBM-admission fallback: a refused
        growth triggers a compaction (frees the overlay) and ONE
        retry against the fresh minimum-capacity buffer."""
        try:
            return self.overlay.append_edges(a_s, a_d, a_l)
        except Exception:
            self._compact([], why="hbm admission")
            return self.overlay.append_edges(a_s, a_d, a_l)

    def _overlay_apply(self, payloads: list) -> None:
        if not payloads:
            return
        t0 = time.time()
        idm = self.graph.idm
        snap = self.snapshot
        vids = snap.vertex_ids
        added = tombed = 0
        for p in payloads:
            # adds land before this payload's removals so a remove in a
            # later commit (or the same one) can target them; multiset
            # semantics make within-payload order immaterial
            a_s: list = []
            a_d: list = []
            a_l: list = []
            for r in p.get("added", ()):
                if "in" not in r:      # property mutation: the dense
                    snap.vertex_values.pop(r.get("type"), None)
                    continue           # columns go stale, arrays don't
                st = self._resolve(r["type"])
                if st is None or (self._label_ids is not None
                                  and st.id not in self._label_ids):
                    continue
                u = int(np.searchsorted(
                    vids, idm.canonical_vertex_id(r["out"])))
                v = int(np.searchsorted(
                    vids, idm.canonical_vertex_id(r["in"])))
                code = idm.count(st.id)
                snap.label_names.setdefault(code, st.name)
                a_s.append(u)
                a_d.append(v)
                a_l.append(code)
            if a_s:
                s = np.asarray(a_s, np.int32)
                d = np.asarray(a_d, np.int32)
                lb = np.asarray(a_l, np.int32)
                if not self.directed:
                    s, d = (np.concatenate([s, d]),
                            np.concatenate([d, s]))
                    lb = np.concatenate([lb, lb])
                added += self._append(s, d, lb)
                # the append may have compacted: re-bind the published
                # base (same vertex set, so dense indices stay valid)
                snap = self.snapshot
                vids = snap.vertex_ids
            for r in p.get("removed", ()):
                if "in" not in r:
                    snap.vertex_values.pop(r.get("type"), None)
                    continue
                st = self._resolve(r["type"])
                if st is None:
                    continue
                cu = idm.canonical_vertex_id(r["out"])
                cv = idm.canonical_vertex_id(r["in"])
                iu = int(np.searchsorted(vids, cu))
                iv = int(np.searchsorted(vids, cv))
                if iu >= len(vids) or vids[iu] != cu \
                        or iv >= len(vids) or vids[iv] != cv:
                    continue           # ghost endpoints: rebuild would
                lab = idm.count(st.id)  # not see the edge either
                if self.overlay.remove_edge(iu, iv, lab):
                    tombed += 1
                # undirected bases hold the mirror row too
                if not self.directed \
                        and self.overlay.remove_edge(iv, iu, lab):
                    tombed += 1
        if added:
            self._metrics.counter("serving.live.edges_added").inc(added)
        if tombed:
            self._metrics.counter(
                "serving.live.edges_tombstoned").inc(tombed)
        self._metrics.counter("serving.live.deltas_applied").inc(
            len(payloads))
        self._metrics.histogram("serving.live.apply_ms").update(
            (time.time() - t0) * 1e3)
        if self._tracer is not None:
            self._tracer.event("live", "apply", t0=t0,
                               payloads=len(payloads),
                               edges_added=added, tombstoned=tombed,
                               epoch=self.epoch, seq=self.overlay.seq)

    # -- epoch boundaries ----------------------------------------------------

    def _publish(self, merged) -> None:
        old = self.snapshot
        self._detach(merged)
        self.snapshot = merged
        self.overlay.close()
        self.overlay = self._new_overlay(merged)
        self.epoch += 1
        if self._republish is not None:
            self._republish(old, merged)

    def _compact(self, extra_payloads: list, why: str = "") -> None:
        t0 = time.time()
        # device merge by default: next epoch's CSR is computed in HBM
        # beside the current one (double-buffered through the ledger)
        # and published pre-attached — no serving gap, no re-upload.
        # Payloads the overlay can't express force the host path (their
        # apply_changes invalidates device caches anyway).
        merged, mode = self.compactor.compact(
            self.snapshot, self.overlay, ledger=self._ledger,
            metrics=self._metrics, host_only=bool(extra_payloads),
            on_resident=self._on_resident)
        if extra_payloads:
            merged.apply_changes(extra_payloads, self.graph.schema,
                                 self.graph.idm)
        self._publish(merged)
        self._metrics.counter("serving.live.compactions").inc()
        self._metrics.histogram("serving.live.compact_ms").update(
            (time.time() - t0) * 1e3)
        if self._tracer is not None:
            self._tracer.event("live", "compact", t0=t0, why=why,
                               mode=mode, epoch=self.epoch)

    def compact_if_dirty(self) -> bool:
        """Force-fold the overlay (dense/PageRank's documented
        compact-before-run fallback). Returns True when a compaction
        happened."""
        return self.compact_now(why="compact-before-run")

    def compact_now(self, why: str = "controller") -> bool:
        """Externally-triggered epoch fold — the autotune controller's
        predicted-merge-cost seam (olap/serving/autotune): compact the
        overlay NOW instead of waiting for the fixed fill/tombstone
        thresholds. Pumps first so the fold covers every visible
        commit; a clean overlay is a no-op. Returns True when a
        compaction happened."""
        with self._lock:
            if self._closed:
                return False
            self._pump_local()
            self._pump_feed()
            if self.overlay.count == 0 and self.overlay.tomb_count == 0:
                return False
            self._compact([], why=why)
            return True

    def _resync(self, why: str) -> None:
        """Full store re-scan: the recovery path when delta continuity
        broke (listener overflow / gap, feed gap). Re-anchors the SAME
        change queue at the scan-verified epoch (core/changes
        ``ChangeQueue.reanchor`` — the overflow flag resets, so delta
        ingest resumes instead of resyncing forever)."""
        from titan_tpu_torch.olap import snapshot as snap_mod

        # floor first: feed batches older than the re-scan are covered
        # by it (the at-least-once boundary, see __init__)
        self._ingest_floor = self.graph.backend.times.time()
        fresh = snap_mod.build(self.graph, labels=self.labels,
                               directed=self.directed,
                               _reuse_listener=(self._token,
                                                self._queue))
        self.applied_epoch = fresh.epoch
        self._label_ids = (fresh._build_params or {}).get("label_ids")
        self._publish(fresh)
        self._metrics.counter("serving.live.resyncs").inc()

    # -- leases / observation ------------------------------------------------

    def lease_state(self) -> tuple:
        """(snapshot, OverlayView, epoch_info) captured atomically — the
        consistent pair new jobs run against. Pumps first, so the local
        lane is as fresh as every commit visible before this call."""
        with self._lock:
            self._pump_local()
            self._pump_feed()
            view = self.overlay.view()
            info = {"epoch": self.epoch, "seq": view.seq,
                    "applied_epoch": self.applied_epoch}
            # convenience for direct model calls on the leased object
            # (serving passes the view explicitly per lease)
            self.snapshot._live_overlay = view
            return self.snapshot, view, info

    def stats(self) -> dict:
        with self._lock:
            g = self.graph
            lag_epochs = max(g.mutation_epoch - self.applied_epoch, 0)
            feed_pending = self.feed.pending() if self.feed else 0
            lag_s = self.feed.lag_seconds() if self.feed else 0.0
            m = self._metrics
            return {
                "epoch": self.epoch,
                "applied_epoch": self.applied_epoch,
                "seq": self.overlay.seq,
                "freshness": {
                    "lag_epochs": lag_epochs + feed_pending,
                    "lag_seconds": round(lag_s, 4),
                    "feed_pending": feed_pending,
                },
                "overlay": self.overlay.stats(),
                # active thresholds + merge mode (device/host) +
                # fallback reasons, as GET /live serves them
                "compactor": self.compactor.policy(),
                "counters": {
                    k: m.counter_value(f"serving.live.{k}")
                    for k in _LIVE_COUNTERS},
                "apply_ms": m.histogram("serving.live.apply_ms")
                             .to_dict(),
                "compact_ms": m.histogram("serving.live.compact_ms")
                               .to_dict(),
                "compact_device_ms":
                    m.histogram("serving.live.compact_device_ms")
                     .to_dict(),
            }
