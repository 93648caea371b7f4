"""KCVS adapter over GNU dbm (libgdbm) — a third-party storage
engine this project did not write (the port's copy of
``titan_tpu/storage/gdbmkv.py``; its records are byte-equal to the JAX
package's, the gdbm files themselves are in hash order and need not be).

Purpose: every reference adapter targets an
industry system the Titan authors did not build
(reference: titan-cassandra/.../thrift/CassandraThriftStoreManager.java,
titan-hbase-parent/.../HBaseStoreManager.java:383-384); this adapter
plays that role here and proves the KCVS SPI (storage/api.py) is
portable to an engine with its own on-disk format and API, not just to
stores written against the SPI.

Mapping: gdbm is a HASH key->value store, so each KCVS row (key ->
ordered columns) serializes into ONE gdbm record (length-prefixed sorted
column/value pairs), one gdbm file per KCVS store. gdbm iterates keys in
hash order only; the adapter maintains a per-store sorted key index —
rebuilt by one firstkey/nextkey sweep at open, updated on mutate — to
honor the ordered-scan contract (the BerkeleyJE adapter gets this from
the engine; a hash engine needs the adapter to supply it, which is
itself evidence the SPI seam is in the right place).

No engine transactions: mutations apply immediately (``transactional``
False); ``sync`` runs on store-transaction commit. Single-writer engine:
a process-wide lock serializes access, matching gdbm's model.

The engine is reached through ``LibGdbm``: libgdbm, the C library
behind ``dbm.gnu``, bound with ctypes, so the store runs on a Python
built without the ``_gdbm`` module too. It opens with the flags
``dbm.gnu.open(path, "c")`` passes, so ``dbm.gnu`` reads the files it
writes and the other way round.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import struct
import threading
from bisect import bisect_left, insort
from typing import Iterator, Optional, Sequence

from titan_tpu_torch.storage.api import (Entry, KeyColumnValueStore,
                                         KeyColumnValueStoreManager,
                                         KeyRangeQuery, KeySliceQuery,
                                         SliceQuery, StoreFeatures,
                                         StoreTransaction,
                                         TransactionHandleConfig)


def _encode_row(cols: list[tuple[bytes, bytes]]) -> bytes:
    parts = [struct.pack(">I", len(cols))]
    for col, val in cols:
        parts.append(struct.pack(">I", len(col)))
        parts.append(col)
        parts.append(struct.pack(">I", len(val)))
        parts.append(val)
    return b"".join(parts)


def _decode_row(data: bytes) -> list[tuple[bytes, bytes]]:
    (n,) = struct.unpack_from(">I", data, 0)
    pos = 4
    out = []
    for _ in range(n):
        (lc,) = struct.unpack_from(">I", data, pos)
        pos += 4
        col = data[pos:pos + lc]
        pos += lc
        (lv,) = struct.unpack_from(">I", data, pos)
        pos += 4
        out.append((col, data[pos:pos + lv]))
        pos += lv
    return out


class _Datum(ctypes.Structure):
    _fields_ = [("dptr", ctypes.c_void_p), ("dsize", ctypes.c_int)]


# gdbm.h: gdbm_open's flags and gdbm_store's
_GDBM_WRCREAT = 2
_GDBM_REPLACE = 1


class LibGdbm:
    """The part of ``dbm.gnu``'s database object the store uses
    (``firstkey``, ``nextkey``, ``get``, ``in``, item set and delete,
    ``sync``, ``close``), over libgdbm through ctypes; opened as
    ``dbm.gnu.open(path, "c")`` opens."""

    _lib = None

    @classmethod
    def _library(cls):
        if cls._lib is None:
            name = ctypes.util.find_library("gdbm")
            if name is None:
                raise ImportError("libgdbm is not available: the gdbm "
                                  "store needs GNU dbm")
            lib = ctypes.CDLL(name)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.gdbm_open.restype = p
            lib.gdbm_open.argtypes = [ctypes.c_char_p, i, i, i, p]
            for fn in ("gdbm_fetch", "gdbm_nextkey"):
                getattr(lib, fn).restype = _Datum
                getattr(lib, fn).argtypes = [p, _Datum]
            lib.gdbm_firstkey.restype = _Datum
            lib.gdbm_firstkey.argtypes = [p]
            lib.gdbm_store.restype = i
            lib.gdbm_store.argtypes = [p, _Datum, _Datum, i]
            for fn in ("gdbm_delete", "gdbm_exists"):
                getattr(lib, fn).restype = i
                getattr(lib, fn).argtypes = [p, _Datum]
            for fn in ("gdbm_sync", "gdbm_close"):
                getattr(lib, fn).restype = None
                getattr(lib, fn).argtypes = [p]
            lib.gdbm_strerror.restype = ctypes.c_char_p
            lib.gdbm_strerror.argtypes = [i]
            lib.gdbm_errno_location.restype = ctypes.POINTER(i)
            libc = ctypes.CDLL(None)
            libc.free.argtypes = [p]
            cls._lib = (lib, libc)
        return cls._lib

    def __init__(self, path: str):
        self._l, self._libc = self._library()
        self._db = self._l.gdbm_open(os.fsencode(path), 0, _GDBM_WRCREAT,
                                     0o666, None)
        if not self._db:
            raise OSError(f"gdbm_open {path}: {self._error()}")

    def _error(self) -> str:
        code = self._l.gdbm_errno_location()[0]
        return self._l.gdbm_strerror(code).decode()

    @staticmethod
    def _datum(data: bytes):
        buf = ctypes.create_string_buffer(data, max(len(data), 1))
        return _Datum(ctypes.cast(buf, ctypes.c_void_p), len(data)), buf

    def _take(self, d) -> Optional[bytes]:
        """The bytes of a datum libgdbm allocated, which is then freed."""
        if not d.dptr:
            return None
        try:
            return ctypes.string_at(d.dptr, d.dsize)
        finally:
            self._libc.free(d.dptr)

    def firstkey(self) -> Optional[bytes]:
        return self._take(self._l.gdbm_firstkey(self._db))

    def nextkey(self, key: bytes) -> Optional[bytes]:
        d, _buf = self._datum(key)
        return self._take(self._l.gdbm_nextkey(self._db, d))

    def get(self, key: bytes) -> Optional[bytes]:
        d, _buf = self._datum(key)
        return self._take(self._l.gdbm_fetch(self._db, d))

    def __contains__(self, key: bytes) -> bool:
        d, _buf = self._datum(key)
        return bool(self._l.gdbm_exists(self._db, d))

    def __setitem__(self, key: bytes, value: bytes) -> None:
        k, _kb = self._datum(key)
        v, _vb = self._datum(value)
        if self._l.gdbm_store(self._db, k, v, _GDBM_REPLACE) != 0:
            raise OSError(f"gdbm_store: {self._error()}")

    def __delitem__(self, key: bytes) -> None:
        d, _buf = self._datum(key)
        if self._l.gdbm_delete(self._db, d) != 0:
            raise KeyError(key)

    def sync(self) -> None:
        self._l.gdbm_sync(self._db)

    def close(self) -> None:
        if self._db:
            self._l.gdbm_close(self._db)
            self._db = None


def open_gdbm(path: str) -> LibGdbm:
    """A GNU dbm file opened read-write, created if absent."""
    return LibGdbm(path)


class GdbmStore(KeyColumnValueStore):
    def __init__(self, manager: "GdbmStoreManager", name: str):
        self._manager = manager
        self._name = name
        self._lock = manager._lock
        path = os.path.join(manager.directory, name + ".gdbm")
        self._db = open_gdbm(path)
        # ordered-scan index: one hash-order sweep at open
        keys: list[bytes] = []
        k = self._db.firstkey()
        while k is not None:
            keys.append(k)
            k = self._db.nextkey(k)
        keys.sort()
        self._keys = keys

    @property
    def name(self) -> str:
        return self._name

    def _row(self, key: bytes) -> list[tuple[bytes, bytes]]:
        data = self._db.get(key)
        return _decode_row(data) if data is not None else []

    @staticmethod
    def _slice(cols: list[tuple[bytes, bytes]], q: SliceQuery) -> list[Entry]:
        out = []
        for col, val in cols:
            if q.contains(col):
                out.append(Entry(col, val))
                if q.limit is not None and len(out) >= q.limit:
                    break
        return out

    def get_slice(self, query: KeySliceQuery,
                  txh: StoreTransaction) -> list[Entry]:
        with self._lock:
            return self._slice(self._row(query.key), query.slice)

    def get_slice_multi(self, keys: Sequence[bytes], slice_query: SliceQuery,
                        txh: StoreTransaction) -> dict:
        with self._lock:
            return {k: self._slice(self._row(k), slice_query) for k in keys}

    def mutate(self, key: bytes, additions: Sequence[Entry],
               deletions: Sequence[bytes], txh: StoreTransaction) -> None:
        with self._lock:
            cols = dict(self._row(key))
            for col in deletions:
                cols.pop(col, None)
            for e in additions:
                cols[e.column] = e.value
            had = key in self._db
            if cols:
                self._db[key] = _encode_row(sorted(cols.items()))
                if not had:
                    insort(self._keys, key)
            elif had:
                del self._db[key]
                i = bisect_left(self._keys, key)
                if i < len(self._keys) and self._keys[i] == key:
                    self._keys.pop(i)

    def acquire_lock(self, key: bytes, column: bytes,
                     expected: Optional[bytes],
                     txh: StoreTransaction) -> None:
        raise NotImplementedError(
            "gdbm has no native locking; the backend layers the "
            "consistent-key locker on top (features.locking = False)")

    def get_keys(self, query, txh: StoreTransaction) -> Iterator:
        if isinstance(query, KeyRangeQuery):
            with self._lock:
                lo = bisect_left(self._keys, query.key_start)
                hi = bisect_left(self._keys, query.key_end) \
                    if query.key_end is not None else len(self._keys)
                keys = self._keys[lo:hi]
            sl = query.slice
            key_limit = query.key_limit
        else:
            with self._lock:
                keys = list(self._keys)
            sl = query
            key_limit = None
        yielded = 0
        for k in keys:
            if key_limit is not None and yielded >= key_limit:
                return
            with self._lock:
                entries = self._slice(self._row(k), sl)
            if entries:         # key_limit counts rows that MATCH the slice
                yield k, entries
                yielded += 1

    def sync(self) -> None:
        with self._lock:
            self._db.sync()

    def close(self) -> None:
        with self._lock:
            self._db.close()


class _GdbmTx(StoreTransaction):
    def __init__(self, manager: "GdbmStoreManager",
                 config: Optional[TransactionHandleConfig] = None):
        super().__init__(config)
        self._manager = manager

    def commit(self) -> None:
        self._manager._sync_all()

    def rollback(self) -> None:    # mutations apply immediately (see module
        pass                       # doc); rollback is a no-op like inmemory


class GdbmStoreManager(KeyColumnValueStoreManager):
    """One gdbm file per store under ``directory``."""

    def __init__(self, directory: str, **_ignored):
        if not directory:
            raise ValueError("storage.directory is required for gdbm")
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self._lock = threading.RLock()
        self._stores: dict[str, GdbmStore] = {}

    @property
    def name(self) -> str:
        return f"gdbm:{self.directory}"

    @property
    def features(self) -> StoreFeatures:
        return StoreFeatures(ordered_scan=True, unordered_scan=True,
                             key_ordered=True, batch_mutation=True,
                             multi_query=True, key_consistent=True,
                             persists=True)

    def open_database(self, name: str) -> GdbmStore:
        store = self._stores.get(name)
        if store is None:
            store = GdbmStore(self, name)
            self._stores[name] = store
        return store

    def begin_transaction(self, config: Optional[TransactionHandleConfig]
                          = None) -> _GdbmTx:
        return _GdbmTx(self, config)

    def mutate_many(self, mutations: dict, txh: StoreTransaction) -> None:
        for store_name, by_key in mutations.items():
            store = self.open_database(store_name)
            for key, mut in by_key.items():
                store.mutate(key, mut.additions, mut.deletions, txh)

    def get_local_key_partition(self) -> Optional[list]:
        return None

    def _sync_all(self) -> None:
        for s in self._stores.values():
            s.sync()

    def exists(self) -> bool:
        try:
            return any(f.endswith(".gdbm")
                       for f in os.listdir(self.directory))
        except FileNotFoundError:
            return False

    def clear_storage(self) -> None:
        with self._lock:
            for s in self._stores.values():
                s._db.close()
            self._stores.clear()
            for f in os.listdir(self.directory):
                if f.endswith(".gdbm"):
                    os.unlink(os.path.join(self.directory, f))

    def close(self) -> None:
        with self._lock:
            for s in self._stores.values():
                s.close()
            self._stores.clear()
