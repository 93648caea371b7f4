"""In-process KCVS backend — the bootstrap/test backend.

Counterpart of the reference's in-memory store (reference: titan-core
diskstorage/keycolumnvalue/inmemory/InMemoryStoreManager.java:37-44,
InMemoryKeyColumnValueStore.java, ColumnValueStore.java): full ordered AND
unordered scan support so every upper layer — including OLAP snapshots and
partitioned-vertex handling — runs without an external cluster.

Each row is a pair of parallel sorted lists (columns, values) maintained with
bisect; rows live in a dict with a sorted-key view rebuilt lazily for ordered
scans. One RW-ish lock per store (coarse; this backend optimizes for
simplicity and test determinism, not contention).
"""

from __future__ import annotations

import bisect
import threading
import time as _time
from typing import Iterator, Optional, Sequence

from titan_tpu_torch.storage.api import (Entry, EntryList, KCVMutation, KeyColumnValueStore, entry_ttl,
                                   KeyColumnValueStoreManager, KeyRangeQuery,
                                   KeySliceQuery, SliceQuery, StoreFeatures,
                                   StoreTransaction, TransactionHandleConfig,
                                   apply_slice)


class _Row:
    __slots__ = ("columns", "values", "expires", "ttl_cells")

    def __init__(self):
        self.columns: list[bytes] = []
        self.values: list[bytes] = []
        # wall-clock expiry per column; 0.0 = never (cell TTL support)
        self.expires: list[float] = []
        self.ttl_cells = 0   # count of cells with an expiry; 0 skips scans

    def mutate(self, additions: Sequence[Entry], deletions: Sequence[bytes]):
        for col in deletions:
            i = bisect.bisect_left(self.columns, col)
            if i < len(self.columns) and self.columns[i] == col:
                del self.columns[i]
                del self.values[i]
                if self.expires[i]:
                    self.ttl_cells -= 1
                del self.expires[i]
        now = _time.time()
        for e in additions:
            col, val = e.column, e.value
            ttl = entry_ttl(e)
            exp = now + ttl if ttl > 0 else 0.0
            i = bisect.bisect_left(self.columns, col)
            if i < len(self.columns) and self.columns[i] == col:
                self.values[i] = val
                self.ttl_cells += bool(exp) - bool(self.expires[i])
                self.expires[i] = exp
            else:
                self.columns.insert(i, col)
                self.values.insert(i, val)
                self.expires.insert(i, exp)
                self.ttl_cells += bool(exp)

    def slice(self, q: SliceQuery) -> EntryList:
        lo = bisect.bisect_left(self.columns, q.start)
        hi = bisect.bisect_left(self.columns, q.end) if q.end is not None else len(self.columns)
        if not self.ttl_cells:
            out = [Entry(c, v) for c, v in zip(self.columns[lo:hi],
                                               self.values[lo:hi])]
            return out[:q.limit] if q.limit is not None else out
        now = _time.time()
        out = []
        for c, v, exp in zip(self.columns[lo:hi], self.values[lo:hi],
                             self.expires[lo:hi]):
            if exp and exp <= now:
                continue  # expired cell: lazily hidden, purged on next mutate
            out.append(Entry(c, v))
            if q.limit is not None and len(out) >= q.limit:
                break
        return out

    def purge_expired(self, now: float) -> None:
        if not self.ttl_cells:
            return   # no TTL'd cells: stays O(1) on the hot write path
        live = [i for i, exp in enumerate(self.expires)
                if not exp or exp > now]
        if len(live) != len(self.columns):
            self.columns = [self.columns[i] for i in live]
            self.values = [self.values[i] for i in live]
            self.expires = [self.expires[i] for i in live]
            self.ttl_cells = sum(1 for exp in self.expires if exp)

    @property
    def empty(self) -> bool:
        return not self.columns


class InMemoryStore(KeyColumnValueStore):
    def __init__(self, name: str):
        self._name = name
        self._rows: dict[bytes, _Row] = {}
        self._sorted_keys: Optional[list[bytes]] = None
        self._lock = threading.RLock()

    @property
    def name(self) -> str:
        return self._name

    def get_slice(self, query: KeySliceQuery, txh: StoreTransaction) -> EntryList:
        with self._lock:
            row = self._rows.get(query.key)
            return row.slice(query.slice) if row is not None else []

    def mutate(self, key: bytes, additions: Sequence[Entry],
               deletions: Sequence[bytes], txh: StoreTransaction) -> None:
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                if not additions:
                    return
                row = _Row()
                self._rows[key] = row
                self._sorted_keys = None
            row.mutate(additions, deletions)
            row.purge_expired(_time.time())
            if row.empty:
                del self._rows[key]
                self._sorted_keys = None

    def mutate_row_packed(self, key: bytes, columns, values,
                          txh: StoreTransaction) -> None:
        """Bulk-row upsert (features.packed_ops): a FRESH row adopts the
        pre-sorted lists directly — no per-Entry objects, no bisect
        inserts (the per-cell Python overhead dominated benchmark-scale
        ingest); an existing row falls back to the entry-wise merge."""
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                row = _Row()
                # fresh lists are ADOPTED, not copied (the SPI contract
                # transfers ownership); non-list sequences are copied
                row.columns = columns if type(columns) is list \
                    else list(columns)
                row.values = values if type(values) is list \
                    else list(values)
                row.expires = [0.0] * len(row.columns)
                self._rows[key] = row
                self._sorted_keys = None
                return
        self.mutate(key, [Entry(c, v) for c, v in zip(columns, values)],
                    [], txh)

    def scan_rows_packed(self, txh: StoreTransaction) -> Iterator:
        """Ordered full scan as (key, columns, values) — the row's own
        lists, yielded without Entry materialization (READ-ONLY; see
        the SPI contract). TTL'd rows take the entry path so expired
        cells stay hidden."""
        with self._lock:
            if self._sorted_keys is None:
                self._sorted_keys = sorted(self._rows.keys())
            keys = list(self._sorted_keys)
        for k in keys:
            with self._lock:
                row = self._rows.get(k)
                if row is None:
                    continue
                if row.ttl_cells:
                    # copy under the lock, yield OUTSIDE it — yielding
                    # while holding a non-reentrant lock deadlocks any
                    # consumer that touches the store from its loop
                    # body (and blocks every other thread while the
                    # generator is suspended)
                    entries = row.slice(SliceQuery())
                    cols = [e.column for e in entries]
                    vals = [e.value for e in entries]
                else:
                    cols, vals = row.columns, row.values
            if cols:
                yield k, cols, vals

    def get_keys(self, query, txh: StoreTransaction) -> Iterator:
        with self._lock:
            if self._sorted_keys is None:
                self._sorted_keys = sorted(self._rows.keys())
            keys = self._sorted_keys
            if isinstance(query, KeyRangeQuery):
                lo = bisect.bisect_left(keys, query.key_start)
                hi = bisect.bisect_left(keys, query.key_end) \
                    if query.key_end is not None else len(keys)
                keys = keys[lo:hi]
                key_limit = query.key_limit
                sl = query.slice
            else:
                sl = query
                key_limit = None
                keys = list(keys)
        yielded = 0
        for k in keys:
            if key_limit is not None and yielded >= key_limit:
                return
            with self._lock:
                row = self._rows.get(k)
                entries = row.slice(sl) if row is not None else []
            if entries:  # key_limit counts rows that MATCH the slice
                yield k, entries
                yielded += 1

    def clear(self):
        with self._lock:
            self._rows.clear()
            self._sorted_keys = None

    def row_count(self) -> int:
        with self._lock:
            return len(self._rows)


class InMemoryStoreManager(KeyColumnValueStoreManager):
    def __init__(self, config=None):
        self._stores: dict[str, InMemoryStore] = {}
        self._lock = threading.RLock()

    @property
    def name(self) -> str:
        return "inmemory"

    @property
    def features(self) -> StoreFeatures:
        return StoreFeatures(ordered_scan=True, unordered_scan=True,
                             key_ordered=True, batch_mutation=True,
                             multi_query=True, key_consistent=True,
                             persists=False, cell_ttl=True,
                             packed_ops=True)

    def open_database(self, name: str) -> InMemoryStore:
        with self._lock:
            store = self._stores.get(name)
            if store is None:
                store = InMemoryStore(name)
                self._stores[name] = store
            return store

    def begin_transaction(self, config: Optional[TransactionHandleConfig] = None
                          ) -> StoreTransaction:
        return StoreTransaction(config)

    def close(self) -> None:
        pass

    def clear_storage(self) -> None:
        with self._lock:
            for s in self._stores.values():
                s.clear()
            self._stores.clear()

    def exists(self) -> bool:
        with self._lock:
            return any(s.row_count() for s in self._stores.values())
