"""Cluster-unique id-block allocation over the storage backend.

Re-creation of the reference's lock-free timestamped-claim protocol
(reference: titan-core diskstorage/idmanagement/ConsistentKeyIDAuthority.java:200+,
AbstractIDAuthority.java, IDBlock): allocation never uses locks — an instance
proposes a claim column for the next block, waits out the uncertainty window,
re-reads, and owns the block iff its claim sorts first (earliest timestamp,
uid tiebreak). Losers delete their claim and retry. All coordination happens
through the shared ``system_ids`` store, so any key-consistent backend works.

Claim column layout (byte-ordered so one slice read finds the newest block):

    [ 2^63 - block_end : u64 big-endian ][ timestamp : u64 ][ uid bytes ]

The complement puts the HIGHEST block first; within one block_end, claims
sort by (timestamp, uid) — the total order that picks the winner.
"""

from __future__ import annotations

import abc
import logging
import time as _time
from dataclasses import dataclass

from titan_tpu_torch.errors import IDPoolExhaustedError, TemporaryBackendError
from titan_tpu_torch.storage.api import Entry, KeySliceQuery, SliceQuery
from titan_tpu_torch.storage.tx import backend_op
from titan_tpu_torch.utils.times import TimestampProvider

log = logging.getLogger(__name__)

_COMPL = 1 << 63


@dataclass(frozen=True)
class IDBlock:
    start: int  # inclusive
    end: int    # exclusive

    def __len__(self):
        return self.end - self.start


class IDAuthority(abc.ABC):
    @abc.abstractmethod
    def get_id_block(self, namespace: bytes, block_size: int,
                     timeout_s: float) -> IDBlock: ...

    def close(self) -> None:
        pass


class LocalIDAuthority(IDAuthority):
    """In-process allocator for tests/single-process graphs."""

    def __init__(self):
        import threading
        self._next: dict[bytes, int] = {}
        self._lock = threading.Lock()

    def get_id_block(self, namespace: bytes, block_size: int,
                     timeout_s: float = 0) -> IDBlock:
        with self._lock:
            start = self._next.get(namespace, 1)
            self._next[namespace] = start + block_size
            return IDBlock(start, start + block_size)


def _claim_column(block_end: int, timestamp: int, uid: bytes) -> bytes:
    return ((_COMPL - block_end).to_bytes(8, "big") +
            timestamp.to_bytes(8, "big") + uid)


def _parse_claim(column: bytes) -> tuple[int, int, bytes]:
    block_end = _COMPL - int.from_bytes(column[:8], "big")
    ts = int.from_bytes(column[8:16], "big")
    return block_end, ts, column[16:]


class ConsistentKeyIDAuthority(IDAuthority):
    def __init__(self, store, manager, uid: bytes, times: TimestampProvider,
                 wait_ms: int = 300, base: int = 1):
        self._store = store
        self._manager = manager
        self._uid = uid
        self._times = times
        self._wait = wait_ms / 1000.0
        self._base = base  # first allocatable id (0 is reserved)

    def _tx(self):
        return self._manager.begin_transaction()

    def _read_newest_end(self, namespace: bytes) -> int:
        txh = self._tx()
        try:
            entries = backend_op(
                lambda: self._store.get_slice(
                    KeySliceQuery(namespace, SliceQuery(limit=1)), txh),
                what="idauthority read")
            if not entries:
                return self._base
            block_end, _, _ = _parse_claim(entries[0].column)
            return block_end
        finally:
            txh.commit()

    def get_id_block(self, namespace: bytes, block_size: int,
                     timeout_s: float = 120.0) -> IDBlock:
        deadline = _time.monotonic() + timeout_s
        backoff = 0.01
        while _time.monotonic() < deadline:
            next_start = self._read_newest_end(namespace)
            target_end = next_start + block_size
            ts = self._times.time()
            mine = _claim_column(target_end, ts, self._uid)

            txh = self._tx()
            try:
                self._store.mutate(namespace, [Entry(mine, b"\x01")], [], txh)
                txh.commit()
            except TemporaryBackendError:
                _time.sleep(backoff)
                backoff = min(backoff * 2, 1.0)
                continue

            # uncertainty window: let racing claims become visible
            self._times.sleep_past(ts + int(self._wait * self._times.unit_per_second))

            # re-read ALL claims for this block_end; first sorted wins
            prefix = (_COMPL - target_end).to_bytes(8, "big")
            txh = self._tx()
            try:
                claims = backend_op(
                    lambda: self._store.get_slice(
                        KeySliceQuery(namespace,
                                      SliceQuery(prefix, prefix + b"\xff" * 17)),
                        txh),
                    what="idauthority verify")
            finally:
                txh.commit()
            same_block = [e.column for e in claims
                          if e.column.startswith(prefix)]
            if same_block and same_block[0] == mine:
                return IDBlock(next_start, target_end)

            # lost the race: withdraw our claim and retry
            txh = self._tx()
            try:
                self._store.mutate(namespace, [], [mine], txh)
                txh.commit()
            except TemporaryBackendError:
                pass  # stale claim is harmless: it names an already-won block
            _time.sleep(backoff)
            backoff = min(backoff * 2, 1.0)
        raise IDPoolExhaustedError(
            f"could not claim an id block in {timeout_s}s for {namespace!r}")
