"""Trigger logs + change streaming: the application-facing TitanBus.

(reference: titan-core docs/TitanBus.md:5-13 — transactions tagged with a
log identifier write their change set to the user log ``ulog_<id>`` at
commit; graphdb/log/StandardLogProcessorFramework.java +
core/log/LogProcessorFramework.java deliver a ``ChangeState`` of
added/removed elements per committed transaction to registered processors.)

The port's copy of ``titan_tpu/core/changes.py``: the in-process side
(``ChangeQueue``, ``ChangeState``, ``change_payload``) and the durable
log's processors (``LogProcessorFramework``).

Payload layout (self-describing serializer):
  {"txid": int, "time": int,
   "added_vertices": [vid...], "removed_vertices": [vid...],
   "added": [rel...], "removed": [rel...]}
rel = {"rel_id", "type", "out", "in"(edges) | "value"(properties)}
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from titan_tpu_torch.storage.log import LogMessage, ReadMarker

log_ = logging.getLogger(__name__)

USER_LOG_PREFIX = "ulog_"

# in-process listener backlog bound: past this, the queue declares
# overflow and the subscriber must full-rebuild instead of delta-refresh
CHANGE_QUEUE_CAP = 10_000


class ChangeQueue(list):
    """Bounded change-payload backlog for in-process subscribers (list
    subclass so the graph's registry can hold it by WEAK reference —
    builtin lists aren't weak-referenceable). ``overflowed`` means
    payloads were dropped: delta refresh is no longer sound. The cap is
    configurable per graph (computer.tpu.change-backlog)."""

    __slots__ = ("__weakref__", "overflowed", "cap")

    def __init__(self, cap: int = CHANGE_QUEUE_CAP):
        super().__init__()
        self.overflowed = False
        self.cap = cap

    def push(self, payload: dict) -> None:
        if self.overflowed:
            return
        if len(self) >= self.cap:
            self.overflowed = True
            self.clear()
            return
        self.append(payload)

    def reanchor(self) -> None:
        """Resume accumulation after the subscriber re-anchored at a
        freshly rebuilt epoch (``GraphSnapshot.rebuild_in_place`` /
        the live plane's resync): the dropped backlog is covered by the
        rebuild's store scan, so the overflow verdict no longer applies.
        Must be called under the graph's commit lock, atomically with
        the rebuild's epoch verification — otherwise a commit racing
        the clear could land in storage but not in the queue. Without
        the reset, one backlog past the cap would force every later
        refresh() into a full rebuild."""
        self.clear()
        self.overflowed = False


class ChangeState:
    """One committed transaction's change set, as delivered to processors
    (reference: core/log/ChangeState.java). ``sender`` is the writing
    instance's rid bytes when the state arrived over the durable log
    (None for states built directly from payloads) — the live plane's
    ChangeFeed uses it to drop this instance's own messages, which it
    already saw through the in-process listener."""

    def __init__(self, payload: dict, sender: Optional[bytes] = None):
        self._p = payload
        self.sender = sender

    @property
    def txid(self) -> int:
        return self._p["txid"]

    @property
    def timestamp(self) -> int:
        return self._p.get("time", 0)

    def added_vertices(self) -> list[int]:
        return list(self._p.get("added_vertices", ()))

    def removed_vertices(self) -> list[int]:
        return list(self._p.get("removed_vertices", ()))

    def added_relations(self, type_name: Optional[str] = None) -> list[dict]:
        return [r for r in self._p.get("added", ())
                if type_name is None or r.get("type") == type_name]

    def removed_relations(self, type_name: Optional[str] = None) -> list[dict]:
        return [r for r in self._p.get("removed", ())
                if type_name is None or r.get("type") == type_name]

    def added_edges(self, type_name: Optional[str] = None) -> list[dict]:
        return [r for r in self.added_relations(type_name) if "in" in r]

    def added_properties(self, type_name: Optional[str] = None) -> list[dict]:
        return [r for r in self.added_relations(type_name) if "in" not in r]


def change_payload(graph, tx, txid: int) -> dict:
    """Serialize a committed tx's deltas (called from the commit path)."""

    def rel_dict(rel) -> dict:
        d = {"rel_id": rel.relation_id,
             "type": tx.schema_name(rel.type_id),
             "out": rel.out_vertex_id}
        if rel.is_edge:
            d["in"] = rel.in_vertex_id
        else:
            d["value"] = rel.value
        return d

    sys = graph.schema.system
    return {
        "txid": txid,
        "time": graph.backend.times.time(),
        "added_vertices": sorted(tx._new_vertices),
        "removed_vertices": sorted(tx._removed_vertices),
        "added": [rel_dict(r) for r in tx._added.values()
                  if not sys.is_system(r.type_id)],
        "removed": [rel_dict(r) for r in tx._deleted.values()
                    if not sys.is_system(r.type_id)],
    }


class LogProcessorBuilder:
    def __init__(self, framework: "LogProcessorFramework", identifier: str):
        self._framework = framework
        self._identifier = identifier
        self._processors: list[Callable] = []
        self._start_time: Optional[int] = None
        self._reader_id: Optional[str] = None
        self._read_interval_ms: Optional[int] = None

    def set_start_time_now(self) -> "LogProcessorBuilder":
        self._start_time = None
        return self

    def set_start_time(self, t: int) -> "LogProcessorBuilder":
        self._start_time = t
        return self

    def set_processor_identifier(self, ident: str) -> "LogProcessorBuilder":
        """Named readers persist their cursor and resume where they stopped
        (reference: durable read markers, KCVSLog.java:31-35)."""
        self._reader_id = ident
        return self

    def set_read_interval_ms(self, ms: int) -> "LogProcessorBuilder":
        self._read_interval_ms = ms
        return self

    def add_processor(self, fn: Callable) -> "LogProcessorBuilder":
        """fn(graph, txid, change_state)"""
        self._processors.append(fn)
        return self

    def build(self) -> None:
        self._framework._register(self._identifier, self._reader_id,
                                  self._start_time, list(self._processors),
                                  self._read_interval_ms)


class LogProcessorFramework:
    """(reference: StandardLogProcessorFramework — obtained via
    ``titan_tpu_torch.open_log_processors(graph)``)"""

    def __init__(self, graph):
        self.graph = graph
        self._lock = threading.Lock()
        self._logs: list = []

    def add_log_processor(self, identifier: str) -> LogProcessorBuilder:
        return LogProcessorBuilder(self, identifier)

    def _register(self, identifier: str, reader_id: Optional[str],
                  start_time: Optional[int], processors: list,
                  read_interval_ms: Optional[int] = None) -> None:
        overrides = {}
        if read_interval_ms is not None:
            overrides["read_interval_ms"] = read_interval_ms
        log = self.graph.backend.log_manager.open_log(
            USER_LOG_PREFIX + identifier, **overrides)
        ser = self.graph.serializer

        def on_message(msg: LogMessage) -> None:
            # per-message/per-processor error isolation: a raising processor
            # must not wedge the bucket cursor and stall the whole stream
            # (reference: StandardLogProcessorFramework catches per-processor
            # Throwables)
            try:
                state = ChangeState(ser.value_from_bytes(msg.content),
                                    sender=msg.sender)
            except Exception:
                log_.warning("undecodable change message on %s; skipped",
                             identifier, exc_info=True)
                return
            for fn in processors:
                try:
                    fn(self.graph, state.txid, state)
                except Exception:
                    log_.warning("change processor %r failed for tx %s",
                                 fn, state.txid, exc_info=True)

        marker = ReadMarker(identifier=reader_id, start_time=start_time)
        log.register_reader(marker, on_message)
        with self._lock:
            self._logs.append(log)
