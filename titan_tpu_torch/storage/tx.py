"""Backend transaction: buffered mutations + retried reads over all stores.

Re-creation of the reference's BackendTransaction / CacheTransaction /
BackendOperation stack (reference: titan-core diskstorage/BackendTransaction.java,
keycolumnvalue/cache/CacheTransaction.java:213, util/BackendOperation.java):

* ``backend_op`` — run a backend call with bounded retries + exponential
  backoff on TemporaryBackendError; PermanentBackendError escalates at once.
* ``BufferedMutator`` — accumulates KCVMutations per (store, key), flushing
  through ``mutate_many`` whenever ``buffer_size`` mutations accumulate, so
  one batched call replaces thousands of point writes.
* ``BackendTransaction`` — the per-graph-tx façade: reads go through the
  store caches; writes buffer; commit flushes buffers, commits the store tx,
  then commits index-provider transactions.
"""

from __future__ import annotations

import logging
import time as _time
from typing import Callable, Optional, Sequence, TypeVar

from titan_tpu_torch.errors import PermanentBackendError, TemporaryBackendError
from titan_tpu_torch.storage.api import (Entry, EntryList, KCVMutation,
                                   KeyColumnValueStoreManager, KeySliceQuery,
                                   SliceQuery, StoreTransaction)
from titan_tpu_torch.storage.cache import StoreCache

log = logging.getLogger(__name__)

T = TypeVar("T")


def backend_op(fn: Callable[[], T], attempts: int = 3,
               wait_ms: int = 250, what: str = "backend op") -> T:
    """Execute with retries on TemporaryBackendError (exponential backoff).
    (reference: diskstorage/util/BackendOperation.java)"""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    delay = wait_ms / 1000.0
    last: Optional[Exception] = None
    for attempt in range(attempts):
        try:
            return fn()
        except TemporaryBackendError as e:
            last = e
            log.warning("%s failed temporarily (attempt %d/%d): %s",
                        what, attempt + 1, attempts, e)
            if attempt + 1 < attempts:
                _time.sleep(delay)
                delay *= 2
        except PermanentBackendError:
            raise
    raise TemporaryBackendError(
        f"{what} failed after {attempts} attempts") from last


class BufferedMutator:
    """Buffers mutations per (store, key); flushes via mutate_many.
    (reference: keycolumnvalue/cache/CacheTransaction.java)"""

    def __init__(self, manager: KeyColumnValueStoreManager,
                 store_tx: StoreTransaction, buffer_size: int = 1024,
                 attempts: int = 5, wait_ms: int = 250,
                 invalidations: Optional[dict] = None):
        self._manager = manager
        self._store_tx = store_tx
        self._buffer_size = buffer_size
        self._attempts = attempts
        self._wait_ms = wait_ms
        self._pending: dict[str, dict[bytes, KCVMutation]] = {}
        self._pending_count = 0
        # store name -> StoreCache, for post-flush invalidation
        self._invalidations = invalidations or {}

    def mutate(self, store_name: str, key: bytes,
               additions: Sequence[Entry] = (),
               deletions: Sequence[bytes] = ()) -> None:
        by_key = self._pending.setdefault(store_name, {})
        m = by_key.get(key)
        if m is None:
            by_key[key] = KCVMutation(list(additions), list(deletions))
            self._pending_count += 1
        else:
            m.merge(KCVMutation(list(additions), list(deletions)))
        if self._pending_count >= self._buffer_size:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        batch = self._pending
        self._pending = {}
        self._pending_count = 0
        for by_key in batch.values():
            for m in by_key.values():
                m.consolidate()
        try:
            backend_op(lambda: self._manager.mutate_many(batch, self._store_tx),
                       self._attempts, self._wait_ms, "mutate_many")
        except BaseException:
            # restore the batch so a later flush/commit retries instead of
            # silently committing without these writes
            for store_name, by_key in batch.items():
                dest = self._pending.setdefault(store_name, {})
                for key, m in by_key.items():
                    if key in dest:
                        m.merge(dest[key])
                        dest[key] = m
                    else:
                        dest[key] = m
                        self._pending_count += 1
            raise
        for store_name, by_key in batch.items():
            cache = self._invalidations.get(store_name)
            if cache is not None:
                for key in by_key:
                    cache.invalidate(key)

    @property
    def has_pending(self) -> bool:
        return bool(self._pending)


class BackendTransaction:
    """Per-graph-transaction façade over the edge store, index store and
    external index providers (reference: diskstorage/BackendTransaction.java)."""

    def __init__(self, store_tx: StoreTransaction,
                 manager: KeyColumnValueStoreManager,
                 edge_store: StoreCache, index_store: StoreCache,
                 buffer_size: int = 1024, attempts: int = 3,
                 wait_ms: int = 250, write_attempts: Optional[int] = None,
                 index_txs: Optional[dict] = None,
                 parallel_pool=None):
        self.store_tx = store_tx
        self._manager = manager
        self.edge_store = edge_store
        self.index_store = index_store
        self._attempts = attempts
        self._wait_ms = wait_ms
        self.mutator = BufferedMutator(
            manager, store_tx, buffer_size,
            write_attempts if write_attempts is not None else attempts, wait_ms,
            invalidations={edge_store.store.name: edge_store,
                           index_store.store.name: index_store})
        self.index_txs = index_txs or {}   # index name -> IndexTransaction
        self._pool = parallel_pool

    # -- reads ---------------------------------------------------------------

    def _read(self, fn, what):
        return backend_op(fn, self._attempts, self._wait_ms, what)

    def edge_store_query(self, query: KeySliceQuery) -> EntryList:
        return self._read(lambda: self.edge_store.get_slice(query, self.store_tx),
                          "edgeStoreQuery")

    def edge_store_multi_query(self, keys: Sequence[bytes],
                               sq: SliceQuery) -> dict:
        return self._read(
            lambda: self.edge_store.get_slice_multi(keys, sq, self.store_tx),
            "edgeStoreMultiQuery")

    def edge_store_keys(self, query):
        return self.edge_store.store.get_keys(query, self.store_tx)

    def index_query(self, query: KeySliceQuery) -> EntryList:
        return self._read(lambda: self.index_store.get_slice(query, self.store_tx),
                          "indexQuery")

    def index_multi_query(self, keys: Sequence[bytes], sq: SliceQuery) -> dict:
        return self._read(
            lambda: self.index_store.get_slice_multi(keys, sq, self.store_tx),
            "indexMultiQuery")

    # -- writes --------------------------------------------------------------

    def mutate_edges(self, key: bytes, additions: Sequence[Entry] = (),
                     deletions: Sequence[bytes] = ()) -> None:
        self.mutator.mutate(self.edge_store.store.name, key, additions, deletions)

    def mutate_index(self, key: bytes, additions: Sequence[Entry] = (),
                     deletions: Sequence[bytes] = ()) -> None:
        self.mutator.mutate(self.index_store.store.name, key, additions, deletions)

    def acquire_edge_lock(self, key: bytes, column: bytes,
                          expected: Optional[bytes] = None) -> None:
        self.edge_store.store.acquire_lock(key, column, expected, self.store_tx)

    def acquire_index_lock(self, key: bytes, column: bytes,
                           expected: Optional[bytes] = None) -> None:
        self.index_store.store.acquire_lock(key, column, expected, self.store_tx)

    # -- lifecycle -----------------------------------------------------------

    def commit_storage(self) -> None:
        self.mutator.flush()
        self.store_tx.commit()

    def commit_indexes(self) -> None:
        for itx in self.index_txs.values():
            itx.commit()

    def commit(self) -> None:
        self.commit_storage()
        self.commit_indexes()

    def rollback(self) -> None:
        exc = None
        try:
            self.store_tx.rollback()
        except Exception as e:  # keep rolling back the rest
            exc = e
        for itx in self.index_txs.values():
            try:
                itx.rollback()
            except Exception as e:
                exc = exc or e
        if exc is not None:
            raise exc
