"""Backend read cache with penalized invalidation.

Counterpart of the reference's KCVS cache layer (reference: titan-core
diskstorage/keycolumnvalue/cache/ExpirationKCVSCache.java:226,
NoKCVSCache.java): a read-through slice cache in front of the edgestore /
graphindex stores. Invalidated ("dirty") keys are blacklisted for a grace
period so concurrent readers can't resurrect a stale slice that was read
just before the invalidating commit landed.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence

from titan_tpu_torch.storage.api import (EntryList, KeyColumnValueStore, KeySliceQuery,
                                   SliceQuery, StoreTransaction)


class StoreCache:
    """Wraps a KeyColumnValueStore with get_slice caching. Not itself a
    KeyColumnValueStore — BackendTransaction routes reads through it and
    writes around it (with invalidation), like the reference's KCVSCache."""

    def __init__(self, store: KeyColumnValueStore):
        self.store = store

    def get_slice(self, query: KeySliceQuery, txh: StoreTransaction) -> EntryList:
        return self.store.get_slice(query, txh)

    def get_slice_multi(self, keys: Sequence[bytes], sq: SliceQuery,
                        txh: StoreTransaction) -> dict:
        return self.store.get_slice_multi(keys, sq, txh)

    def invalidate(self, key: bytes) -> None:
        pass

    def clear(self) -> None:
        pass


NoCache = StoreCache


class ExpirationStoreCache(StoreCache):
    def __init__(self, store: KeyColumnValueStore, max_entries: int = 200_000,
                 expire_ms: int = 10_000, clean_wait_ms: int = 50):
        super().__init__(store)
        self._max = max_entries
        self._expire_s = expire_ms / 1000.0
        self._grace_s = clean_wait_ms / 1000.0
        self._cache: OrderedDict[tuple, tuple] = OrderedDict()  # (key,start,end,limit) -> (entries, t)
        self._by_key: dict[bytes, set] = {}   # key -> cache keys (for O(1) invalidation)
        self._dirty: dict[bytes, float] = {}  # key -> blacklist-until
        self._dirty_sweep_at = 1024
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def _usable(self, key: bytes, t: float) -> bool:
        until = self._dirty.get(key)
        if until is None:
            return True
        if t >= until:
            del self._dirty[key]
            return True
        return False

    def _sweep_dirty(self, now: float) -> None:
        """Bound _dirty: drop expired blacklist entries once it grows large
        (the reference's ExpirationKCVSCache runs a periodic penalty-map
        cleanup thread; we sweep inline on growth instead)."""
        if len(self._dirty) < self._dirty_sweep_at:
            return
        expired = [k for k, until in self._dirty.items() if now >= until]
        for k in expired:
            del self._dirty[k]
        if len(self._dirty) >= self._dirty_sweep_at:
            self._dirty_sweep_at *= 2
        elif self._dirty_sweep_at > 1024:
            self._dirty_sweep_at = max(1024, len(self._dirty) * 2)

    def _insert(self, ck: tuple, entries, t: float) -> None:
        self._cache[ck] = (entries, t)
        self._cache.move_to_end(ck)
        self._by_key.setdefault(ck[0], set()).add(ck)
        while len(self._cache) > self._max:
            old_ck, _ = self._cache.popitem(last=False)
            refs = self._by_key.get(old_ck[0])
            if refs is not None:
                refs.discard(old_ck)
                if not refs:
                    del self._by_key[old_ck[0]]

    def _cache_key(self, q: KeySliceQuery) -> tuple:
        return (q.key, q.slice.start, q.slice.end, q.slice.limit)

    def get_slice(self, query: KeySliceQuery, txh: StoreTransaction) -> EntryList:
        ck = self._cache_key(query)
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(ck)
            if hit is not None and now - hit[1] < self._expire_s and \
                    self._usable(query.key, now):
                self._cache.move_to_end(ck)
                self.hits += 1
                return hit[0]
        entries = self.store.get_slice(query, txh)
        with self._lock:
            self.misses += 1
            t = time.monotonic()
            if self._usable(query.key, t):
                self._insert(ck, entries, t)
        return entries

    def get_slice_multi(self, keys: Sequence[bytes], sq: SliceQuery,
                        txh: StoreTransaction) -> dict:
        out = {}
        missing = []
        now = time.monotonic()
        with self._lock:
            for k in keys:
                ck = (k, sq.start, sq.end, sq.limit)
                hit = self._cache.get(ck)
                if hit is not None and now - hit[1] < self._expire_s and \
                        self._usable(k, now):
                    self._cache.move_to_end(ck)
                    self.hits += 1
                    out[k] = hit[0]
                else:
                    missing.append(k)
        if missing:
            fetched = self.store.get_slice_multi(missing, sq, txh)
            with self._lock:
                t = time.monotonic()
                for k, entries in fetched.items():
                    self.misses += 1
                    out[k] = entries
                    if self._usable(k, t):
                        self._insert((k, sq.start, sq.end, sq.limit), entries, t)
        return out

    def invalidate(self, key: bytes) -> None:
        with self._lock:
            now = time.monotonic()
            self._dirty[key] = now + self._grace_s
            self._sweep_dirty(now)
            for ck in self._by_key.pop(key, ()):
                self._cache.pop(ck, None)

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._by_key.clear()
            self._dirty.clear()
