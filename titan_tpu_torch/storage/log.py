"""Durable pub/sub log bus inside the storage backend ("TitanBus").

Re-creation of the reference's KCVS log (reference: titan-core
diskstorage/log/kcvs/KCVSLog.java:839 — message keys are
(partition, bucket, timeslice) rows; writers buffer and round-robin buckets;
reader threads poll each bucket from a durable read marker; delivery is
at-least-once; docs/TitanBus.md). This single primitive carries the WAL
(``txlog``), schema/config broadcasts (``systemlog``) and user trigger logs.

Row key:    [name-len u8][log name][bucket u8][timeslice u64]
Column:     [timestamp u64][writer rid][seq u32]      (time-ordered)
Value:      payload bytes
Marker row: [0xFF][name-len u8][log name][reader id]  (column = bucket)
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass
from typing import Callable, Optional

from titan_tpu_torch.errors import TemporaryBackendError
from titan_tpu_torch.storage.api import Entry, KeySliceQuery, SliceQuery
from titan_tpu_torch.storage.tx import backend_op
from titan_tpu_torch.utils.times import TimestampProvider

TIMESLICE_UNITS = 10_000_000  # 10s at micro resolution


@dataclass
class LogMessage:
    content: bytes
    timestamp: int
    sender: bytes


class ReadMarker:
    """Where a named reader starts: now, a fixed time, or its saved cursor.
    (reference: diskstorage/log/ReadMarker.java)"""

    def __init__(self, identifier: Optional[str] = None,
                 start_time: Optional[int] = None):
        self.identifier = identifier
        self.start_time = start_time

    @classmethod
    def from_now(cls):
        return cls()

    @classmethod
    def from_time(cls, t: int):
        return cls(start_time=t)

    @classmethod
    def from_identifier(cls, ident: str, fallback_time: Optional[int] = None):
        return cls(identifier=ident, start_time=fallback_time)


class KCVSLog:
    def __init__(self, name: str, store, manager, rid: bytes,
                 times: TimestampProvider, num_buckets: int = 1,
                 send_batch: int = 256, send_delay_ms: int = 0,
                 read_interval_ms: int = 200):
        self.name = name
        self._store = store
        self._manager = manager
        self._rid = rid
        self._times = times
        self._num_buckets = num_buckets
        self._send_batch = send_batch
        self._send_delay = send_delay_ms / 1000.0
        self._read_interval = read_interval_ms / 1000.0
        self._seq = 0
        self._next_bucket = 0
        self._outgoing: list[tuple[int, bytes, bytes]] = []  # (bucket, col, payload)
        self._lock = threading.Lock()
        self._readers: list[tuple] = []   # (callback, marker, thread, stop_event)
        self._closed = False
        self._flusher: Optional[threading.Thread] = None

    # -- keys ----------------------------------------------------------------

    def _row(self, bucket: int, timeslice: int) -> bytes:
        nb = self.name.encode()
        return bytes([len(nb)]) + nb + bytes([bucket]) + \
            timeslice.to_bytes(8, "big")

    def _marker_row(self, reader_id: str) -> bytes:
        nb = self.name.encode()
        return b"\xff" + bytes([len(nb)]) + nb + reader_id.encode()

    def _timeslice(self, ts: int) -> int:
        unit = self._times.unit_per_second
        return ts // (10 * unit)

    # -- writing -------------------------------------------------------------

    def add(self, content: bytes, flush: bool = True) -> None:
        """Append a message (at-least-once durable once flushed)."""
        if self._closed:
            raise TemporaryBackendError(f"log {self.name} closed")
        with self._lock:
            ts = self._times.time()
            col = ts.to_bytes(8, "big") + self._rid + \
                self._seq.to_bytes(4, "big")
            self._seq += 1
            bucket = self._next_bucket
            self._next_bucket = (self._next_bucket + 1) % self._num_buckets
            self._outgoing.append((bucket, col, content))
            should_flush = flush and self._send_delay == 0 or \
                len(self._outgoing) >= self._send_batch
        if should_flush:
            self.flush()
        elif self._send_delay > 0 and self._flusher is None:
            self._start_flusher()

    def flush(self) -> None:
        with self._lock:
            batch, self._outgoing = self._outgoing, []
        if not batch:
            return
        by_row: dict[bytes, list] = {}
        for bucket, col, payload in batch:
            ts = int.from_bytes(col[:8], "big")
            row = self._row(bucket, self._timeslice(ts))
            by_row.setdefault(row, []).append(Entry(col, payload))
        def write():
            txh = self._manager.begin_transaction()
            try:
                for row, entries in by_row.items():
                    self._store.mutate(row, entries, [], txh)
                txh.commit()
            except BaseException:
                txh.rollback()
                raise
        backend_op(write, what=f"log[{self.name}] flush")

    def _start_flusher(self):
        def loop():
            while not self._closed:
                _time.sleep(self._send_delay)
                try:
                    self.flush()
                except Exception:
                    pass
        self._flusher = threading.Thread(target=loop, daemon=True,
                                         name=f"log-{self.name}-flush")
        self._flusher.start()

    # -- reading -------------------------------------------------------------

    def register_reader(self, marker: ReadMarker,
                        callback: Callable[[LogMessage], None]) -> None:
        start = marker.start_time
        if marker.identifier is not None:
            saved = self._load_marker(marker.identifier)
            if saved:
                # per-bucket cursors: a lagging bucket must resume from ITS
                # read position, not the max across buckets, or its unread
                # messages would be skipped (at-least-once guarantee)
                fallback = marker.start_time
                if fallback is None:
                    fallback = min(saved.values())
                start = {b: saved.get(b, fallback)
                         for b in range(self._num_buckets)}
        if start is None:
            start = self._times.time()
        stop = threading.Event()
        thread = threading.Thread(
            target=self._read_loop, args=(marker, callback, start, stop),
            daemon=True, name=f"log-{self.name}-reader")
        self._readers.append((callback, marker, thread, stop))
        thread.start()

    def _load_marker(self, ident: str) -> Optional[dict]:
        """→ {bucket: last-read ts} or None when no marker was persisted."""
        txh = self._manager.begin_transaction()
        try:
            entries = self._store.get_slice(
                KeySliceQuery(self._marker_row(ident), SliceQuery()), txh)
        finally:
            txh.commit()
        if not entries:
            return None
        return {e.column[0]: int.from_bytes(e.value, "big") for e in entries}

    def _save_marker(self, ident: str, bucket: int, ts: int) -> None:
        txh = self._manager.begin_transaction()
        try:
            self._store.mutate(self._marker_row(ident),
                               [Entry(bytes([bucket]), ts.to_bytes(8, "big"))],
                               [], txh)
            txh.commit()
        except BaseException:
            txh.rollback()

    def _read_loop(self, marker: ReadMarker, callback, start,
                   stop: threading.Event) -> None:
        if isinstance(start, dict):
            cursors = dict(start)
        else:
            cursors = {b: start for b in range(self._num_buckets)}
        while not stop.is_set() and not self._closed:
            for bucket in range(self._num_buckets):
                try:
                    cursors[bucket] = self._poll_bucket(bucket, cursors[bucket],
                                                        callback)
                    if marker.identifier is not None:
                        self._save_marker(marker.identifier, bucket,
                                          cursors[bucket])
                except Exception:
                    pass  # at-least-once: retry next poll
            stop.wait(self._read_interval)

    def _poll_bucket(self, bucket: int, cursor: int, callback) -> int:
        """Ordered key-range scan over this bucket's timeslice rows from the
        cursor's slice upward (one ranged scan, not one get per slice)."""
        from titan_tpu_torch.storage.api import KeyRangeQuery
        now = self._times.time()
        start_row = self._row(bucket, self._timeslice(cursor))
        end_row = self._row(bucket, self._timeslice(now) + 1)
        new_cursor = cursor
        txh = self._manager.begin_transaction()
        try:
            rows = list(self._store.get_keys(
                KeyRangeQuery(start_row, end_row,
                              SliceQuery(start=cursor.to_bytes(8, "big"))),
                txh))
        finally:
            txh.commit()
        for _, entries in rows:
            for e in entries:
                ts = int.from_bytes(e.column[:8], "big")
                if ts < cursor:
                    continue
                sender = e.column[8:-4]
                callback(LogMessage(e.value, ts, sender))
                new_cursor = max(new_cursor, ts + 1)
        return new_cursor

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._closed = True
        for _, _, thread, stop in self._readers:
            stop.set()
        for _, _, thread, stop in self._readers:
            thread.join(timeout=2)


class LogManager:
    """Opens named logs over a backend store (reference: KCVSLogManager.java)."""

    def __init__(self, manager, store_name: str, rid: bytes,
                 times: TimestampProvider, **log_kwargs):
        self._manager = manager
        self._store = manager.open_database(store_name)
        self._rid = rid
        self._times = times
        self._kwargs = log_kwargs
        self._logs: dict[str, KCVSLog] = {}
        self._lock = threading.Lock()

    def open_log(self, name: str, **overrides) -> KCVSLog:
        with self._lock:
            log = self._logs.get(name)
            if log is None:
                kw = dict(self._kwargs)
                kw.update(overrides)
                log = KCVSLog(name, self._store, self._manager, self._rid,
                              self._times, **kw)
                self._logs[name] = log
            elif "read_interval_ms" in overrides:
                # the cached instance must honor a caller's interval — the
                # reader loops re-read this attribute every poll, so the
                # change takes effect immediately
                log._read_interval = overrides["read_interval_ms"] / 1000.0
            return log

    def close(self) -> None:
        with self._lock:
            for log in self._logs.values():
                log.close()
            self._logs.clear()
