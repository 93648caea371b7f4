"""Epoch-aware snapshot pool: jobs share snapshots, never stale ones (the
port's copy of ``titan_tpu/olap/serving/pool.py``).

One ``GraphSnapshot`` per (labels, edge_keys, directed) parameter set is
shared by every concurrent job, leased under the snapshot's epoch and
``refresh()`` contract (``olap/snapshot.py``):

* fresh: lease it;
* stale with no active leases: ``refresh()`` in place (no store scan);
  a refresh that raises (a delta gap, a backlog overflow, extracted
  edge_values) falls back to ``rebuild_in_place()``, then to a new
  build;
* stale with active leases: a live run must not see its arrays change,
  so the pool builds a replacement and retires the old snapshot, which
  is closed when its last lease is released.

The snapshot ``acquire()`` returns has ``epoch >= graph.mutation_epoch``
as read when the call began. ``SnapshotPool(snapshot=...)`` pins one
fixed snapshot instead, leased before ``labels`` or ``directed`` are
looked at, so it answers every label set (as in the JAX package).
``SnapshotPool(live=plane)`` leases the live plane's (snapshot, overlay
view) pairs (``olap/live/plane.py``).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence


class Lease:
    """Context-managed snapshot lease; ``release()`` (or ``with``) must
    run exactly once. ``overlay``/``epoch_info`` are set on live-plane
    leases: the overlay view frozen at the same epoch as the snapshot
    (the consistent pair jobs run against) and the epoch descriptor jobs
    report; other leases leave them None."""

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
    """See module doc. A fixed snapshot stays the caller's: the pool never
    closes it. ``on_close(snap)`` is told of every snapshot the pool
    discards (the scheduler drops its ledger entry and device caches).

    ``live=`` attaches a ``olap/live.LiveGraphPlane``: acquires whose key
    matches the plane's (labels, no edge_keys, directed) lease the
    plane's current (snapshot, overlay view) pair at a consistent epoch
    instead of building or refreshing; a compaction republishes, and the
    old base retires when its last lease drops, as on the
    replace-when-leased path. Other keys go through build and refresh."""

    def __init__(self, graph=None, snapshot=None, on_close=None,
                 live=None):
        if live is not None and graph is None:
            graph = live.graph
        if graph is None and snapshot is None:
            raise ValueError("SnapshotPool needs a graph, a snapshot "
                             "or a live plane")
        self.graph = graph
        self._fixed = snapshot
        self._live = live
        if live is not None:
            live._republish = self._live_republish
        self._entries: dict = {}      # key -> current snapshot
        self._leases: dict = {}       # id(snap) -> count
        self._retired: dict = {}      # id(snap) -> snap awaiting close
        self._keylocks: dict = {}     # key -> builder lock (slow path)
        self._lock = threading.Lock()
        self._closed = False
        self.on_close = on_close

    def _close_snap(self, snap) -> None:
        if self.on_close is not None:
            try:
                self.on_close(snap)
            except Exception:    # noqa: BLE001 — the close must go on
                pass
        snap.close()

    @staticmethod
    def key_of(labels: Optional[Sequence[str]] = None,
               edge_keys: Sequence[str] = (),
               directed: bool = False) -> tuple:
        return (tuple(labels) if labels is not None else None,
                tuple(edge_keys), bool(directed))

    # -- lease plumbing -----------------------------------------------------

    def _release(self, snap) -> None:
        to_close = None
        with self._lock:
            sid = id(snap)
            left = self._leases.get(sid, 1) - 1
            if left > 0:
                self._leases[sid] = left
            else:
                self._leases.pop(sid, None)
                to_close = self._retired.pop(sid, None)
        if to_close is not None:
            self._close_snap(to_close)

    def _lease_locked(self, snap) -> Lease:
        self._leases[id(snap)] = self._leases.get(id(snap), 0) + 1
        return Lease(snap, self._release)

    def _live_republish(self, old, new) -> None:
        """The plane's compaction and resync hook: the previous base
        leaves the serving plane, retired while leases hold it and closed
        outright otherwise (``on_close`` drops its ledger entry and
        device caches either way)."""
        to_close = None
        with self._lock:
            if self._leases.get(id(old), 0) > 0:
                self._retired[id(old)] = old
            else:
                to_close = old
        if to_close is not None:
            self._close_snap(to_close)

    def _acquire_live(self, compacted: bool) -> Lease:
        plane = self._live
        # plane lock → pool lock is the global order (republish runs
        # under the plane lock and takes the pool lock); holding it
        # across the lease keeps the (snapshot, view) pair and the
        # lease count atomic with any concurrent compaction
        with plane._lock:
            if compacted:
                plane.compact_if_dirty()
            snap, view, info = plane.lease_state()
            with self._lock:
                if self._closed:
                    raise RuntimeError("pool is closed")
                lease = self._lease_locked(snap)
                lease.overlay = view
                lease.epoch_info = info
                return lease

    # -- acquisition --------------------------------------------------------

    def acquire(self, labels: Optional[Sequence[str]] = None,
                edge_keys: Sequence[str] = (),
                directed: bool = False,
                compacted: bool = False) -> Lease:
        """Lease a snapshot for these parameters whose epoch covers every
        commit visible before this call. ``compacted`` (the live plane's
        compact-before-run, for dense window sweeps) folds the plane's
        overlay first; other leases ignore it.

        The pool lock guards only the maps, so ``stats()`` and fast-path
        acquires never wait behind a store scan; build() and refresh()
        run under a per-key builder lock. A concurrent fast-path acquire
        cannot lease a snapshot mid-refresh: its epoch is stamped last,
        so it reads as stale until the refresh ends."""
        if self._fixed is not None:
            with self._lock:
                if self._closed:
                    raise RuntimeError("pool is closed")
                return self._lease_locked(self._fixed)
        from titan_tpu_torch.olap import snapshot as snap_mod

        key = self.key_of(labels, edge_keys, directed)
        if self._live is not None and key == self._live.pool_key:
            return self._acquire_live(compacted)
        e0 = self.graph.mutation_epoch
        with self._lock:
            if self._closed:
                raise RuntimeError("pool is closed")
            snap = self._entries.get(key)
            if snap is not None and snap.epoch >= e0 and not snap.stale:
                return self._lease_locked(snap)     # fast path
            klock = self._keylocks.setdefault(key, threading.Lock())
        with klock:
            while True:
                with self._lock:
                    if self._closed:
                        raise RuntimeError("pool is closed")
                    snap = self._entries.get(key)
                    if snap is not None and snap.epoch >= e0 \
                            and not snap.stale:
                        return self._lease_locked(snap)
                    if snap is not None \
                            and self._leases.get(id(snap), 0) > 0:
                        # live runs hold the old arrays: retire, rebuild
                        self._retired[id(snap)] = snap
                        self._entries.pop(key, None)
                        snap = None
                if snap is None:
                    new = snap_mod.build(self.graph, labels=labels,
                                         edge_keys=edge_keys,
                                         directed=directed)
                    with self._lock:
                        self._entries[key] = new
                        # build()'s verified scan stamps an epoch >= e0
                        # (it began after e0 was read)
                        return self._lease_locked(new)
                try:
                    snap.refresh()
                except (RuntimeError, NotImplementedError):
                    # a delta gap, an overflow or edge_values: rebuild,
                    # never fail the job. With no leases out (the key
                    # lock is held, so none can appear) the rebuild is in
                    # place and re-anchors the change queue; otherwise
                    # the snapshot is replaced
                    with self._lock:
                        leased = self._leases.get(id(snap), 0) > 0
                    if not leased:
                        try:
                            snap.rebuild_in_place()
                            continue
                        except Exception:   # noqa: BLE001
                            pass     # fall through: replace wholesale
                    with self._lock:
                        if self._entries.get(key) is snap:
                            self._entries.pop(key)
                    self._close_snap(snap)
                    continue
                if snap.epoch >= e0:
                    with self._lock:
                        return self._lease_locked(snap)
                # a commit landed inside refresh(): loop and check again

    def ready(self) -> tuple:
        """Readiness probe: can this pool hand out a current-epoch
        snapshot now? Returns (ok, why)."""
        with self._lock:
            if self._closed:
                return False, "pool closed"
            if self._live is not None:
                return True, f"live plane at epoch {self._live.epoch}"
            if self._fixed is not None:
                return True, "fixed snapshot resident"
            if self.graph is not None:
                return True, (f"graph-backed "
                              f"({len(self._entries)} resident)")
            return False, "no snapshot source"

    def stats(self) -> dict:
        with self._lock:
            out = {"entries": len(self._entries),
                   # resident snapshots, a fixed one included
                   "snapshots": len(self._entries)
                   + (1 if self._fixed is not None else 0),
                   "active_leases": sum(self._leases.values()),
                   "retired": len(self._retired)}
        if self._live is not None:
            out["live_epoch"] = self._live.epoch
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            snaps = list(self._entries.values()) \
                + list(self._retired.values())
            self._entries.clear()
            self._retired.clear()
            self._leases.clear()
        for s in snaps:
            if s is not self._fixed:
                self._close_snap(s)
