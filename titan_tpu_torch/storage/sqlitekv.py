"""SQLite-backed persistent KCVS — the embedded single-machine backend (the
port's copy of ``titan_tpu/storage/sqlitekv.py``).

Plays the role the reference fills with BerkeleyJE (reference:
titan-berkeleyje/.../BerkeleyJEStoreManager.java, BerkeleyJEKeyValueStore.java,
adapted through diskstorage/keycolumnvalue/keyvalue/
OrderedKeyValueStoreManagerAdapter.java): an embedded, ACID, key-ordered,
range-scannable local store. Instead of translating the KV-adapter stack we
implement the KCVS contract directly on a relational schema —
``(key BLOB, column BLOB, value BLOB, PRIMARY KEY(key, column))`` — which
gives ordered key+column iteration and real transactions from sqlite's WAL.

Each StoreTransaction owns its own sqlite connection (isolation =
serializable via sqlite's locking); autocommit reads outside transactions use
a shared connection under a lock.
"""

from __future__ import annotations

import os
import sqlite3
import threading
import time as _time
from typing import Iterator, Optional, Sequence

from titan_tpu_torch.errors import PermanentBackendError, TemporaryBackendError
from titan_tpu_torch.storage.api import (Entry, EntryList, KeyColumnValueStore, entry_ttl,
                                   KeyColumnValueStoreManager, KeyRangeQuery,
                                   KeySliceQuery, SliceQuery, StoreFeatures,
                                   StoreTransaction, TransactionHandleConfig)

_MULTI_CHUNK = 500       # keys per IN(...) statement (SQLITE_MAX_VARIABLE_NUMBER)
_SCAN_PAGE = 4096        # rows per page when scanning via the shared connection


def _table(name: str) -> str:
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"kcvs_{safe}"


def _wrap_sqlite_errors(fn):
    """Map sqlite exceptions onto the backend taxonomy so backend_op's retry
    layer actually retries transient lock/busy conditions."""
    def inner(*a, **kw):
        try:
            return fn(*a, **kw)
        except sqlite3.OperationalError as e:
            msg = str(e).lower()
            if "locked" in msg or "busy" in msg:
                raise TemporaryBackendError(str(e)) from e
            raise PermanentBackendError(str(e)) from e
        except sqlite3.Error as e:
            raise PermanentBackendError(str(e)) from e
    return inner


class SqliteTransaction(StoreTransaction):
    """Split-connection transaction: reads run on a deferred-snapshot
    connection, writes on a separate BEGIN IMMEDIATE connection opened at
    the first write.

    Why: sqlite (WAL) refuses to upgrade a deferred read snapshot to a
    write lock once ANY other connection has committed — SQLITE_BUSY with
    no busy-wait, unrecoverable without restarting the whole tx. The graph
    engine's transactions are exactly that shape (read phase, then one
    batched mutation flush at commit), so under ANY concurrency (a peer
    instance, an id-block renewal) single-connection txs livelock. With
    the split: reads keep one consistent snapshot; the write connection
    takes the lock up front with proper 30s busy-waiting and commits the
    whole batch atomically. Write-then-read within ONE store tx loses
    read-your-writes — no internal caller does that (the graph buffers all
    mutations until commit; id-authority/locking/log use one tx per op).
    """

    def __init__(self, manager: "SqliteStoreManager",
                 config: Optional[TransactionHandleConfig] = None):
        super().__init__(config)
        self._manager = manager
        self._read_conn: Optional[sqlite3.Connection] = None
        self._write_conn: Optional[sqlite3.Connection] = None
        self._lock = threading.Lock()
        self.closed = False

    def connection(self, write: bool = False) -> sqlite3.Connection:
        with self._lock:
            if self.closed:
                raise PermanentBackendError("transaction already closed")
            if write:
                if self._write_conn is None:
                    conn = self._manager._new_connection()
                    try:
                        conn.execute("BEGIN IMMEDIATE")
                    except sqlite3.OperationalError as e:
                        conn.close()
                        raise TemporaryBackendError(str(e)) from e
                    self._write_conn = conn
                return self._write_conn
            if self._read_conn is None:
                self._read_conn = self._manager._new_connection()
                self._read_conn.execute("BEGIN")
            return self._read_conn

    def commit(self) -> None:
        with self._lock:
            if self.closed:
                return
            if self._write_conn is not None:
                try:
                    self._write_conn.commit()
                except sqlite3.OperationalError as e:
                    # leave the tx OPEN so a retry actually re-commits
                    # instead of hitting the closed-tx early exit and
                    # faking success
                    raise TemporaryBackendError(str(e)) from e
                self._write_conn.close()
                self._write_conn = None
            if self._read_conn is not None:
                self._read_conn.rollback()   # just releases the snapshot
                self._read_conn.close()
                self._read_conn = None
            self.closed = True

    def rollback(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            for conn in (self._write_conn, self._read_conn):
                if conn is not None:
                    conn.rollback()
                    conn.close()
            self._write_conn = None
            self._read_conn = None


class SqliteStore(KeyColumnValueStore):
    def __init__(self, manager: "SqliteStoreManager", name: str):
        self._manager = manager
        self._name = name
        self._table = _table(name)

    @property
    def name(self) -> str:
        return self._name

    def _ensure(self, txh: StoreTransaction) -> None:
        # migration first: it ALTERs via the shared connection, and must
        # land before any tx connection snapshots the schema
        self._manager._migrate_ttl_column(self._table)
        self._manager._ensure_table(self._table)

    @_wrap_sqlite_errors
    def _execute(self, txh: StoreTransaction, sql: str, params=()) -> list:
        """Run a query and fetch all rows (fetch happens under the shared-
        connection lock so concurrent writers can't corrupt cursor state)."""
        self._ensure(txh)
        if isinstance(txh, SqliteTransaction):
            return txh.connection().execute(sql, params).fetchall()
        return self._manager._shared_execute(sql, params)

    @staticmethod
    def _bounds(prefix: str, lo: bytes, hi: Optional[bytes], params: list) -> str:
        cond = f"{prefix} >= ?"
        params.append(lo)
        if hi is not None:
            cond += f" AND {prefix} < ?"
            params.append(hi)
        return cond

    def get_slice(self, query: KeySliceQuery, txh: StoreTransaction) -> EntryList:
        q = query.slice
        params: list = [query.key]
        ccond = self._bounds("c", q.start, q.end, params)
        sql = (f"SELECT c, v FROM {self._table} WHERE k = ? AND {ccond} "
               f"AND (e IS NULL OR e > ?) ORDER BY c ASC")
        params.append(_time.time())
        if q.limit is not None:
            sql += " LIMIT ?"
            params.append(q.limit)
        rows = self._execute(txh, sql, params)
        return [Entry(bytes(c), bytes(v)) for c, v in rows]

    def get_slice_multi(self, keys: Sequence[bytes], slice_query: SliceQuery,
                        txh: StoreTransaction) -> dict:
        out = {k: [] for k in keys}
        limit = slice_query.limit
        for i in range(0, len(keys), _MULTI_CHUNK):
            chunk = list(keys)[i:i + _MULTI_CHUNK]
            params: list = list(chunk)
            ccond = self._bounds("c", slice_query.start, slice_query.end, params)
            placeholders = ",".join("?" * len(chunk))
            params.append(_time.time())
            sql = (f"SELECT k, c, v FROM {self._table} WHERE k IN ({placeholders}) "
                   f"AND {ccond} AND (e IS NULL OR e > ?) "
                   f"ORDER BY k ASC, c ASC")
            for k, c, v in self._execute(txh, sql, params):
                lst = out[bytes(k)]
                if limit is None or len(lst) < limit:
                    lst.append(Entry(bytes(c), bytes(v)))
        return out

    @_wrap_sqlite_errors
    def mutate(self, key: bytes, additions: Sequence[Entry],
               deletions: Sequence[bytes], txh: StoreTransaction) -> None:
        if self._manager.read_only:
            raise PermanentBackendError("backend opened read-only")
        del_sql = f"DELETE FROM {self._table} WHERE k = ? AND c = ?"
        add_sql = (f"INSERT OR REPLACE INTO {self._table}(k, c, v, e) "
                   f"VALUES (?, ?, ?, ?)")
        now = _time.time()

        def row(e):
            ttl = entry_ttl(e)
            return (key, e.column, e.value, now + ttl if ttl > 0 else None)

        self._ensure(txh)
        if isinstance(txh, SqliteTransaction):
            conn = txh.connection(write=True)
            conn.executemany(del_sql, [(key, c) for c in deletions])
            conn.executemany(add_sql, [row(e) for e in additions])
        else:
            self._manager._shared_executemany(
                [(del_sql, [(key, c) for c in deletions]),
                 (add_sql, [row(e) for e in additions])])

    def get_keys(self, query, txh: StoreTransaction) -> Iterator:
        """Streaming scan: pages by (key, column) cursor position so the
        shared connection never materializes the whole table and its lock is
        released between pages."""
        if isinstance(query, KeyRangeQuery):
            key_lo, key_hi, sl = query.key_start, query.key_end, query.slice
            key_limit = query.key_limit
        else:
            key_lo, key_hi, sl = b"", None, query
            key_limit = None

        after: Optional[tuple] = None  # (key, column) of last row seen
        current_key: Optional[bytes] = None
        entries: EntryList = []
        yielded = 0
        exhausted = False
        while not exhausted:
            params: list = []
            kcond = self._bounds("k", key_lo, key_hi, params)
            ccond = self._bounds("c", sl.start, sl.end, params)
            params.append(_time.time())
            sql = (f"SELECT k, c, v FROM {self._table} WHERE {kcond} AND {ccond} "
                   f"AND (e IS NULL OR e > ?)")
            if after is not None:
                sql += " AND (k > ? OR (k = ? AND c > ?))"
                params.extend([after[0], after[0], after[1]])
            sql += " ORDER BY k ASC, c ASC LIMIT ?"
            params.append(_SCAN_PAGE)
            rows = self._execute(txh, sql, params)
            exhausted = len(rows) < _SCAN_PAGE
            for k, c, v in rows:
                k, c = bytes(k), bytes(c)
                after = (k, c)
                if k != current_key:
                    if current_key is not None and entries:
                        yield current_key, entries
                        yielded += 1
                        if key_limit is not None and yielded >= key_limit:
                            return
                    current_key = k
                    entries = []
                if sl.limit is None or len(entries) < sl.limit:
                    entries.append(Entry(c, v if isinstance(v, bytes) else bytes(v)))
        if current_key is not None and entries:
            if key_limit is None or yielded < key_limit:
                yield current_key, entries


class SqliteStoreManager(KeyColumnValueStoreManager):
    """``storage.backend=sqlite`` with ``storage.directory`` (or ``:memory:``)."""

    def __init__(self, directory: Optional[str] = None, read_only: bool = False):
        if directory is None or directory == ":memory:":
            # sqlite shared-cache memory DBs use table-level locks that
            # deadlock concurrent tx/shared connections; a temp file under
            # WAL gives real MVCC and is deleted on close.
            import tempfile
            self._tmpdir = tempfile.mkdtemp(prefix="titan_tpu_torch_sqlite_")
            self._path = os.path.join(self._tmpdir, "mem.db")
        else:
            self._tmpdir = None
            os.makedirs(directory, exist_ok=True)
            self._path = os.path.join(directory, "titan_tpu.db")
        self._uri = False
        self.read_only = read_only
        self._shared = self._new_connection()
        self._shared_lock = threading.RLock()
        self._stores: dict[str, SqliteStore] = {}
        self._tables: set[str] = set()
        self._ttl_migrated: set[str] = set()
        self._closed = False

    # -- connection plumbing -------------------------------------------------

    def _new_connection(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self._path, uri=self._uri, timeout=30.0,
                               check_same_thread=False, isolation_level=None)
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    def _shared_execute(self, sql: str, params=()) -> list:
        with self._shared_lock:
            return self._shared.execute(sql, params).fetchall()

    @_wrap_sqlite_errors
    def _shared_executemany(self, batches):
        with self._shared_lock:
            self._shared.execute("BEGIN")
            try:
                for sql, rows in batches:
                    if rows:
                        self._shared.executemany(sql, rows)
                self._shared.commit()
            except BaseException:
                self._shared.rollback()
                raise

    def _ensure_table(self, table: str):
        if table in self._tables:
            return
        with self._shared_lock:
            self._shared.execute(
                f"CREATE TABLE IF NOT EXISTS {table} "
                f"(k BLOB NOT NULL, c BLOB NOT NULL, v BLOB NOT NULL, "
                f"e REAL, "
                f"PRIMARY KEY (k, c)) WITHOUT ROWID")
            self._tables.add(table)

    def _migrate_ttl_column(self, table: str):
        """Databases created before the TTL column existed get it added in
        place (ALTER TABLE); without this, every read/write on old data
        would fail with 'no such column: e'."""
        if table in self._ttl_migrated:
            return
        with self._shared_lock:
            cols = [r[1] for r in self._shared.execute(
                f"PRAGMA table_info({table})").fetchall()]
            if cols and "e" not in cols:
                self._shared.execute(f"ALTER TABLE {table} ADD COLUMN e REAL")
                self._shared.commit()
            self._ttl_migrated.add(table)

    # -- manager SPI ---------------------------------------------------------

    @property
    def name(self) -> str:
        return "sqlite"

    @property
    def features(self) -> StoreFeatures:
        return StoreFeatures(ordered_scan=True, unordered_scan=True,
                             key_ordered=True, transactional=True,
                             batch_mutation=True, multi_query=True,
                             key_consistent=True, persists=True,
                             cell_ttl=True)

    def open_database(self, name: str) -> SqliteStore:
        store = self._stores.get(name)
        if store is None:
            store = SqliteStore(self, name)
            # eager DDL: a table created mid-transaction would be invisible
            # to read snapshots that began earlier
            self._migrate_ttl_column(store._table)
            self._ensure_table(store._table)
            self._stores[name] = store
        return store

    def begin_transaction(self, config: Optional[TransactionHandleConfig] = None
                          ) -> SqliteTransaction:
        return SqliteTransaction(self, config)

    def mutate_many(self, mutations: dict, txh: StoreTransaction) -> None:
        # ensure EVERY table before the first write: DDL runs on the shared
        # connection, which would deadlock against this tx's own write lock
        # if attempted after a previous store's mutate opened it
        # (open_database runs the migrate+create eagerly on first open)
        for store_name in mutations:
            self.open_database(store_name)
        if isinstance(txh, SqliteTransaction):
            for store_name, by_key in mutations.items():
                store = self.open_database(store_name)
                for key, m in by_key.items():
                    store.mutate(key, m.additions, m.deletions, txh)
        else:
            batches = []
            for store_name, by_key in mutations.items():
                store = self.open_database(store_name)
                self._ensure_table(store._table)
                del_sql = f"DELETE FROM {store._table} WHERE k = ? AND c = ?"
                add_sql = (f"INSERT OR REPLACE INTO {store._table}(k, c, v, e) "
                           f"VALUES (?, ?, ?, ?)")
                now = _time.time()
                dels, adds = [], []
                for key, m in by_key.items():
                    dels.extend((key, c) for c in m.deletions)
                    adds.extend(
                        (key, e.column, e.value,
                         now + t if (t := entry_ttl(e)) > 0 else None)
                        for e in m.additions)
                batches.append((del_sql, dels))
                batches.append((add_sql, adds))
            self._shared_executemany(batches)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._shared_lock:
            self._shared.close()
        if self._tmpdir is not None:
            import shutil
            shutil.rmtree(self._tmpdir, ignore_errors=True)

    def clear_storage(self) -> None:
        # DELETE, not DROP: later transactions assume pre-created tables
        # (re-creating one mid-write-tx would deadlock shared-conn DDL
        # against the tx's own write lock)
        with self._shared_lock:
            tables = [r[0] for r in self._shared.execute(
                "SELECT name FROM sqlite_master WHERE type='table' AND "
                "name LIKE 'kcvs_%'").fetchall()]
            for table in tables:
                self._shared.execute(f"DELETE FROM {table}")
            self._shared.commit()
            self._stores.clear()

    def exists(self) -> bool:
        with self._shared_lock:
            row = self._shared.execute(
                "SELECT name FROM sqlite_master WHERE type='table' AND "
                "name LIKE 'kcvs_%' LIMIT 1").fetchone()
            return row is not None
