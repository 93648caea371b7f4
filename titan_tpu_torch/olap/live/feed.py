"""ChangeFeed: tail the durable user trigger log into columnar deltas (the
port's copy of ``titan_tpu/olap/live/feed.py``; host only).

The OLTP→OLAP freshness seam (reference: titan-core docs/TitanBus.md §3 —
``ulog_<id>`` trigger logs + StandardLogProcessorFramework): transactions
tagged with ``log_identifier`` stream their change set to the durable
log at commit; this feed registers a processor through
``core/changes.LogProcessorFramework`` with a RESUMABLE named read
marker (storage/log.KCVSLog per-bucket cursors), so a restarted feed
continues where it stopped instead of replaying history or skipping
writes.

Each delivered ``ChangeState`` becomes one :class:`DeltaBatch` — the
payload re-shaped into columnar numpy arrays (edge adds, edge/vertex
tombstones, property keys) ready for the device overlay — tagged with a
feed-local contiguous ``seq`` so the consumer can verify continuity
(a gap means batches were dropped and the base must resync).

Delivery is at-least-once (the marker is saved AFTER the callback), so
the feed deduplicates by per-sender ``(timestamp, txid)`` watermark;
messages from this instance's own rid are dropped by default — the
in-process listener already delivered them (``skip_sender``).

Backpressure: when more than ``high_watermark`` batches are pending the
log reader thread BLOCKS inside the processor until the consumer drains
below ``low_watermark`` — the durable cursor stops advancing, so no
message is lost while ingest outruns compaction; every stall increments
``serving.live.backpressure``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from titan_tpu_torch.core.changes import LogProcessorFramework
from titan_tpu_torch.utils.metrics import MetricManager


@dataclass
class DeltaBatch:
    """One committed transaction's change set in columnar form."""

    seq: int                      # feed-local contiguous sequence number
    txid: int
    timestamp: int                # backend time units (commit time)
    sender: Optional[bytes]
    received_at: float            # wall clock at ingest
    # edge adds / removes: original vertex ids + edge type names
    add_out: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    add_in: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    add_type: list = field(default_factory=list)
    del_out: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    del_in: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    del_type: list = field(default_factory=list)
    # vertex adds / tombstones
    vtx_add: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    vtx_del: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    # property type names mutated (dense vertex-column invalidation)
    prop_keys: set = field(default_factory=set)

    @property
    def empty(self) -> bool:
        return not (len(self.add_out) or len(self.del_out)
                    or len(self.vtx_add) or len(self.vtx_del)
                    or self.prop_keys)

    @classmethod
    def from_state(cls, seq: int, state) -> "DeltaBatch":
        """Columnarize a ``core/changes.ChangeState``."""
        a_out: list = []
        a_in: list = []
        a_ty: list = []
        d_out: list = []
        d_in: list = []
        d_ty: list = []
        props: set = set()
        for r in state.added_relations():
            if "in" in r:
                a_out.append(r["out"])
                a_in.append(r["in"])
                a_ty.append(r["type"])
            else:
                props.add(r["type"])
        for r in state.removed_relations():
            if "in" in r:
                d_out.append(r["out"])
                d_in.append(r["in"])
                d_ty.append(r["type"])
            else:
                props.add(r["type"])
        return cls(
            seq=seq, txid=state.txid, timestamp=state.timestamp,
            sender=getattr(state, "sender", None),
            received_at=time.time(),
            add_out=np.asarray(a_out, np.int64),
            add_in=np.asarray(a_in, np.int64), add_type=a_ty,
            del_out=np.asarray(d_out, np.int64),
            del_in=np.asarray(d_in, np.int64), del_type=d_ty,
            vtx_add=np.asarray(state.added_vertices(), np.int64),
            vtx_del=np.asarray(state.removed_vertices(), np.int64),
            prop_keys=props)

    def to_payload(self) -> dict:
        """The ``core/changes.change_payload`` dict shape — what
        ``GraphSnapshot.apply_changes`` consumes. This is the
        unification seam: a batch read off the DURABLE log feeds the
        same delta-apply path the in-process listener uses, so
        refresh-style catch-up finally works for cross-instance
        writers."""
        added = [{"type": t, "out": int(o), "in": int(i)}
                 for t, o, i in zip(self.add_type, self.add_out,
                                    self.add_in)]
        added += [{"type": k, "out": 0, "value": None}
                  for k in sorted(self.prop_keys)]
        removed = [{"type": t, "out": int(o), "in": int(i)}
                   for t, o, i in zip(self.del_type, self.del_out,
                                      self.del_in)]
        return {"txid": self.txid, "time": self.timestamp,
                "added_vertices": self.vtx_add.tolist(),
                "removed_vertices": self.vtx_del.tolist(),
                "added": added, "removed": removed}


class ChangeFeed:
    """Durable change-log tail with a resumable cursor (see module doc).

    ``identifier``: the trigger-log name — writers must open their
    transactions with ``graph.new_transaction(log_identifier=...)`` for
    their commits to reach this feed (the TitanBus contract).
    ``reader_id``: names the durable read marker; None starts from
    ``start_time`` (default 0 = log head) without persistence.
    ``skip_sender``: rid bytes whose messages are dropped (defaults to
    the tailing graph's own rid — local commits arrive through the
    in-process listener instead; pass ``b""`` to keep everything).
    """

    def __init__(self, graph, identifier: str, *,
                 reader_id: Optional[str] = None,
                 start_time: Optional[int] = 0,
                 read_interval_ms: int = 50,
                 skip_sender: Optional[bytes] = None,
                 high_watermark: int = 512,
                 low_watermark: Optional[int] = None,
                 metrics: Optional[MetricManager] = None):
        self.graph = graph
        self.identifier = identifier
        self._metrics = metrics or MetricManager.instance()
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._pending: list[DeltaBatch] = []
        self._seq = 0
        self._drained_seq = 0          # highest seq handed to poll()
        self._high = int(high_watermark)
        self._low = int(low_watermark if low_watermark is not None
                        else max(high_watermark // 2, 1))
        self._closed = False
        self._watermarks: dict = {}    # sender -> (timestamp, txid)
        if skip_sender is None:
            skip_sender = getattr(graph.backend.log_manager, "_rid", None)
        self._skip_sender = skip_sender
        self._framework = LogProcessorFramework(graph)
        builder = self._framework.add_log_processor(identifier) \
            .set_read_interval_ms(read_interval_ms) \
            .add_processor(self._on_state)
        if reader_id is not None:
            builder = builder.set_processor_identifier(reader_id)
        if start_time is not None:
            builder = builder.set_start_time(start_time)
        builder.build()

    # -- ingest (log reader thread) ------------------------------------------

    def _on_state(self, graph, txid, state) -> None:
        sender = getattr(state, "sender", None)
        if self._skip_sender and sender == self._skip_sender:
            return
        with self._lock:
            if self._closed:
                return
            # at-least-once dedup: per-sender (timestamp, txid) watermark
            # — bucket scans deliver time-ordered per sender, so a
            # redelivered message compares <= the watermark
            mark = (state.timestamp, txid)
            last = self._watermarks.get(sender)
            if last is not None and mark <= last:
                return
            self._watermarks[sender] = mark
            # backpressure: hold the reader (and therefore the durable
            # cursor) until the consumer drains — ingest must not
            # outrun compaction unboundedly
            if len(self._pending) >= self._high:
                self._metrics.counter("serving.live.backpressure").inc()
                while len(self._pending) >= self._low \
                        and not self._closed:
                    self._space.wait(0.25)
                if self._closed:
                    return
            self._seq += 1
            self._pending.append(DeltaBatch.from_state(self._seq, state))
            self._metrics.counter("serving.live.feed_batches").inc()

    # -- consumption ---------------------------------------------------------

    def poll(self, max_batches: Optional[int] = None) -> list[DeltaBatch]:
        """Pop pending batches in seq order (contiguous — the consumer
        checks ``batch.seq == last + 1`` for continuity)."""
        with self._lock:
            if max_batches is None or max_batches >= len(self._pending):
                out, self._pending = self._pending, []
            else:
                out = self._pending[:max_batches]
                del self._pending[:max_batches]
            if out:
                self._drained_seq = out[-1].seq
            self._space.notify_all()
        return out

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def lag_seconds(self) -> float:
        """Age of the oldest undrained batch (0 when drained)."""
        with self._lock:
            if not self._pending:
                return 0.0
            return max(time.time() - self._pending[0].received_at, 0.0)

    def drain_into(self, snapshot, schema, idm) -> dict:
        """Apply every pending batch to ``snapshot`` through
        ``apply_changes`` — the host-CSR catch-up path for
        cross-instance writers (device-layout caches are invalidated;
        the overlay path in plane.py avoids that). Returns the combined
        apply stats."""
        batches = self.poll()
        totals = {"added_edges": 0, "removed_edges": 0,
                  "added_vertices": 0, "removed_vertices": 0,
                  "batches": len(batches)}
        if batches:
            stats = snapshot.apply_changes(
                [b.to_payload() for b in batches], schema, idm)
            for k, v in stats.items():
                totals[k] = totals.get(k, 0) + v
        return totals

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._space.notify_all()
        # the underlying KCVSLog is shared/cached by the backend's log
        # manager; its readers stop when the graph closes the manager
