"""Snapshot pool: jobs share one leased snapshot (the port's copy of the
fixed-snapshot path of ``titan_tpu/olap/serving/pool.py``).

``SnapshotPool(snapshot=...)`` pins one fixed snapshot (array-built or
externally managed) that every ``acquire()`` leases as-is; leases are
counted so ``stats()`` reports them. The JAX pool's graph-backed path —
one snapshot per (labels, edge_keys, directed) built from the OLTP graph
and refreshed by epoch — needs ``snapshot.build`` (ROADMAP queue 1, item
6b), and its live plane (``live=``) the epoch compactor (item 7); both
raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence


class Lease:
    """Context-managed snapshot lease; ``release()`` (or ``with``) must
    run exactly once. ``overlay``/``epoch_info`` stay None: they belong
    to live-plane leases."""

    __slots__ = ("snapshot", "_release", "_done", "overlay",
                 "epoch_info")

    def __init__(self, snapshot, release):
        self.snapshot = snapshot
        self._release = release
        self._done = False
        self.overlay = None
        self.epoch_info = None

    def release(self) -> None:
        if not self._done:
            self._done = True
            self._release(self.snapshot)

    def __enter__(self):
        return self.snapshot

    def __exit__(self, *exc):
        self.release()
        return False


class SnapshotPool:
    """See module doc. The fixed snapshot stays the caller's: the pool
    never closes it."""

    def __init__(self, graph=None, snapshot=None, live=None):
        if live is not None:
            raise NotImplementedError(
                "SnapshotPool(live=...): the live plane is not ported yet "
                "(ROADMAP queue 1, item 7)")
        if graph is not None:
            raise NotImplementedError(
                "SnapshotPool(graph=...): building snapshots from a graph "
                "is not ported yet (ROADMAP queue 1, item 6b); pass "
                "snapshot=")
        if snapshot is None:
            raise ValueError("SnapshotPool needs a snapshot")
        self._fixed = snapshot
        self._leases: dict = {}       # id(snap) -> count
        self._lock = threading.Lock()
        self._closed = False

    def _release(self, snap) -> None:
        with self._lock:
            sid = id(snap)
            left = self._leases.get(sid, 1) - 1
            if left > 0:
                self._leases[sid] = left
            else:
                self._leases.pop(sid, None)

    def acquire(self, labels: Optional[Sequence[str]] = None,
                edge_keys: Sequence[str] = (),
                directed: bool = False,
                compacted: bool = False) -> Lease:
        """Lease the fixed snapshot (the parameters are the JAX pool's;
        a fixed snapshot answers every set)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("pool is closed")
            sid = id(self._fixed)
            self._leases[sid] = self._leases.get(sid, 0) + 1
            return Lease(self._fixed, self._release)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": 0, "snapshots": 1,
                    "active_leases": sum(self._leases.values()),
                    "retired": 0}

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._leases.clear()
