"""Trigger logs + change streaming: the application-facing TitanBus.

(reference: titan-core docs/TitanBus.md:5-13 — transactions tagged with a
log identifier write their change set to the user log ``ulog_<id>`` at
commit; graphdb/log/StandardLogProcessorFramework.java +
core/log/LogProcessorFramework.java deliver a ``ChangeState`` of
added/removed elements per committed transaction to registered processors.)

The port's copy keeps the in-process side (``ChangeQueue``, ``ChangeState``,
``change_payload``); the log processors (``LogProcessorFramework``) are not
ported (ROADMAP queue 1, item 11).

Payload layout (self-describing serializer):
  {"txid": int, "time": int,
   "added_vertices": [vid...], "removed_vertices": [vid...],
   "added": [rel...], "removed": [rel...]}
rel = {"rel_id", "type", "out", "in"(edges) | "value"(properties)}
"""

from __future__ import annotations

from typing import Optional

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
