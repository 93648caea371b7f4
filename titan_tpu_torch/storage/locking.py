"""Discretionary distributed locking over eventually-consistent stores.

Re-creation of the reference's two-tier locking design (reference: titan-core
diskstorage/locking/LocalLockMediator.java, consistentkey/ConsistentKeyLocker.java:574,
ExpectedValueCheckingStore.java, ExpectedValueCheckingTransaction.java):

1. **LocalLockMediator** — in-process arbitration: co-resident transactions
   contend on a dict before anything hits the store, so only one of them
   pays the remote protocol.
2. **ConsistentKeyLocker** — timestamped claim columns in a dedicated lock
   store: write claim ``[ts][rid]`` under the lock's row, wait out the
   uncertainty window, re-read; the earliest non-expired claim wins. Losers
   withdraw and raise TemporaryLockingError.
3. **Expected-value checking** — each lock remembers the value the caller
   saw; at commit time, before mutating, the wrapped store re-reads and
   verifies nothing changed behind the lock (the reference's defense against
   eventual consistency).

Locks auto-expire after ``expiry_ms`` so crashed holders don't wedge the
cluster; a cleaner deletes stale claims (reference: StandardLockCleanerService).
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass
from typing import NamedTuple, Optional

from titan_tpu_torch.errors import (PermanentLockingError, TemporaryBackendError,
                              TemporaryLockingError)
from titan_tpu_torch.storage.api import Entry, KeySliceQuery, SliceQuery
from titan_tpu_torch.utils.times import TimestampProvider


class LockID(NamedTuple):
    store: str
    key: bytes
    column: bytes


class LocalLockMediator:
    """One mediator per (backend, mediator-group); first claimant wins until
    release or expiry. (reference: LocalLockMediator.java)"""

    _instances: dict[str, "LocalLockMediator"] = {}
    _instances_lock = threading.Lock()

    @classmethod
    def instance(cls, group: str) -> "LocalLockMediator":
        with cls._instances_lock:
            med = cls._instances.get(group)
            if med is None:
                med = cls(group)
                cls._instances[group] = med
            return med

    def __init__(self, group: str):
        self.group = group
        self._locks: dict[LockID, tuple] = {}  # lockid -> (holder, expiry_s)
        self._lock = threading.Lock()

    def claim(self, lockid: LockID, holder, expiry_s: float) -> bool:
        now = _time.monotonic()
        with self._lock:
            cur = self._locks.get(lockid)
            if cur is not None and cur[0] is not holder and cur[1] > now:
                return False
            self._locks[lockid] = (holder, now + expiry_s)
            return True

    def release(self, lockid: LockID, holder) -> None:
        with self._lock:
            cur = self._locks.get(lockid)
            if cur is not None and cur[0] is holder:
                del self._locks[lockid]

    def release_all(self, holder) -> None:
        with self._lock:
            for lid in [l for l, (h, _) in self._locks.items() if h is holder]:
                del self._locks[lid]


def _claim_column(ts: int, rid: bytes) -> bytes:
    return ts.to_bytes(8, "big") + rid


def _lock_row(lockid: LockID) -> bytes:
    # row per (store, key, column); length-prefixed to stay unambiguous
    return (len(lockid.store).to_bytes(2, "big") + lockid.store.encode() +
            len(lockid.key).to_bytes(4, "big") + lockid.key + lockid.column)


@dataclass
class _HeldLock:
    lockid: LockID
    claim: bytes
    expected: Optional[bytes]


class ConsistentKeyLocker:
    def __init__(self, lock_store, manager, rid: bytes,
                 times: TimestampProvider, wait_ms: int = 100,
                 expiry_ms: int = 300_000, retries: int = 3,
                 mediator: Optional[LocalLockMediator] = None):
        self._store = lock_store
        self._manager = manager
        self.rid = rid
        self._times = times
        self._wait = wait_ms
        self._expiry = expiry_ms
        self._retries = retries
        self._mediator = mediator or LocalLockMediator.instance("default")

    def _txh(self):
        return self._manager.begin_transaction()

    def write_lock(self, lockid: LockID, tx_state: "LockState") -> None:
        if lockid in tx_state.held:
            return
        expiry_s = self._expiry / 1000.0
        if not self._mediator.claim(lockid, tx_state, expiry_s):
            raise TemporaryLockingError(
                f"local contention on {lockid} (another tx in this process)")
        try:
            claim = self._write_claim(lockid)
        except BaseException:
            self._mediator.release(lockid, tx_state)
            raise
        tx_state.held[lockid] = _HeldLock(lockid, claim,
                                          tx_state.expected.get(lockid))

    def _write_claim(self, lockid: LockID) -> bytes:
        row = _lock_row(lockid)
        last_exc: Optional[Exception] = None
        for _ in range(self._retries):
            ts = self._times.time()
            mine = _claim_column(ts, self.rid)
            txh = self._txh()
            try:
                self._store.mutate(row, [Entry(mine, b"")], [], txh)
                txh.commit()
            except TemporaryBackendError as e:
                last_exc = e
                continue
            # uncertainty window, then check seniority
            self._times.sleep_past(ts + self._wait * self._times.unit_per_second
                                   // 1000)
            txh = self._txh()
            try:
                claims = self._store.get_slice(
                    KeySliceQuery(row, SliceQuery()), txh)
            finally:
                txh.commit()
            now = self._times.time()
            expiry_units = self._expiry * self._times.unit_per_second // 1000
            live = [c.column for c in claims
                    if now - int.from_bytes(c.column[:8], "big") < expiry_units]
            if live and live[0] == mine:
                return mine
            # lost: withdraw and fail (caller retries the whole tx)
            self._delete_claim(row, mine)
            raise TemporaryLockingError(f"lost lock race on {lockid}")
        raise TemporaryLockingError(
            f"could not write lock claim for {lockid}: {last_exc}")

    def _delete_claim(self, row: bytes, claim: bytes) -> None:
        txh = self._txh()
        try:
            self._store.mutate(row, [], [claim], txh)
            txh.commit()
        except TemporaryBackendError:
            pass  # expired claims get cleaned later

    def check_locks(self, tx_state: "LockState", value_reader) -> None:
        """Before the first mutation: verify every held lock is still ours
        and every expected value still holds. ``value_reader(lockid)``
        returns the current value (or None)."""
        now = self._times.time()
        expiry_units = self._expiry * self._times.unit_per_second // 1000
        for lid, held in tx_state.held.items():
            row = _lock_row(lid)
            txh = self._txh()
            try:
                claims = self._store.get_slice(
                    KeySliceQuery(row, SliceQuery()), txh)
            finally:
                txh.commit()
            live = [c.column for c in claims
                    if now - int.from_bytes(c.column[:8], "big") < expiry_units]
            if not live or live[0] != held.claim:
                raise TemporaryLockingError(f"lock on {lid} lost before commit")
            current = value_reader(lid)
            if lid in tx_state.expected and current != tx_state.expected[lid]:
                raise PermanentLockingError(
                    f"expected value changed under lock {lid}: "
                    f"{tx_state.expected[lid]!r} -> {current!r}")

    def release_locks(self, tx_state: "LockState") -> None:
        for lid, held in list(tx_state.held.items()):
            self._delete_claim(_lock_row(lid), held.claim)
            self._mediator.release(lid, tx_state)
        tx_state.held.clear()

    def clean_expired(self) -> int:
        """Delete stale claims (reference: StandardLockCleanerService).
        Returns number deleted. Scans the lock store."""
        deleted = 0
        now = self._times.time()
        expiry_units = self._expiry * self._times.unit_per_second // 1000
        txh = self._txh()
        try:
            for row, entries in self._store.get_keys(SliceQuery(), txh):
                stale = [e.column for e in entries
                         if now - int.from_bytes(e.column[:8], "big")
                         >= expiry_units]
                if stale:
                    self._store.mutate(row, [], stale, txh)
                    deleted += len(stale)
        finally:
            txh.commit()
        return deleted


class LockState:
    """Per-transaction lock bookkeeping (reference:
    ExpectedValueCheckingTransaction)."""

    def __init__(self):
        self.held: dict[LockID, _HeldLock] = {}
        self.expected: dict[LockID, Optional[bytes]] = {}

    @property
    def has_locks(self) -> bool:
        return bool(self.held)


class LockingStore:
    """Wraps a KCVS store with acquire_lock support backed by the locker.
    (reference: ExpectedValueCheckingStore.java)"""

    def __init__(self, store, locker: ConsistentKeyLocker):
        self.store = store
        self.locker = locker

    def acquire_lock(self, key: bytes, column: bytes,
                     expected: Optional[bytes], tx_state: LockState) -> None:
        lid = LockID(self.store.name, key, column)
        if lid not in tx_state.expected:
            tx_state.expected[lid] = expected
        self.locker.write_lock(lid, tx_state)

    def check_and_release_after(self, tx_state: LockState, value_reader):
        """commit protocol helper: verify then (post-commit) release."""
        self.locker.check_locks(tx_state, value_reader)
