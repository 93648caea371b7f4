"""The storage SPI: the BigTable-style key/column/value contract.

Re-creation of the reference's KCVS SPI (reference: titan-core
diskstorage/keycolumnvalue/KeyColumnValueStore.java:25-178,
KeyColumnValueStoreManager.java:17-56, StoreFeatures/StandardStoreFeatures,
SliceQuery/KeySliceQuery/KeyRangeQuery, KCVMutation): every storage adapter
implements exactly this surface, and every upper layer (graph engine, OLAP
snapshot builder, id authority, locking, log bus) is written against it.

Representation choices (Python/TPU-first, not a translation):
* keys/columns/values are immutable ``bytes`` (the reference's StaticBuffer);
* an entry is an ``Entry(column, value)`` named tuple; a slice result is a
  plain list ordered by column — the bulk scan path additionally exposes
  numpy-backed blocks (storage/scan.py) for zero-copy CSR ingest.
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass, field, replace
from typing import Iterable, Iterator, NamedTuple, Optional, Sequence


class Entry(NamedTuple):
    column: bytes
    value: bytes


class TTLEntry(NamedTuple):
    """Mutation-path entry with a cell TTL in seconds (reference: cell-TTL
    metadata attached in prepareCommit, honored by stores declaring
    features.cell_ttl). Reads always return plain ``Entry``; stores without
    cell-TTL support ignore the ttl field."""
    column: bytes
    value: bytes
    ttl: float


def entry_ttl(e) -> float:
    """TTL seconds of a mutation entry (0 = never expires)."""
    return e.ttl if type(e) is TTLEntry else 0.0


EntryList = list  # list[Entry], ordered by column ascending


class Order(enum.Enum):
    ASC = 1
    DESC = -1


@dataclass(frozen=True)
class SliceQuery:
    """Column interval [start, end) with an optional limit; ``end=None`` means
    unbounded above. (reference: diskstorage/keycolumnvalue/SliceQuery.java)"""
    start: bytes = b""
    end: Optional[bytes] = None
    limit: Optional[int] = None

    def contains(self, column: bytes) -> bool:
        return column >= self.start and (self.end is None or column < self.end)

    def with_limit(self, limit: int) -> "SliceQuery":
        return replace(self, limit=limit)

    def subsumes(self, other: "SliceQuery") -> bool:
        if self.start > other.start:
            return False
        if self.end is not None and (other.end is None or other.end > self.end):
            return False
        if self.limit is None:
            return True
        # a limited result is only reusable for an equally-anchored query:
        # with a different start, the limit may have cut different entries
        return (other.limit is not None and other.limit <= self.limit and
                self.start == other.start)


@dataclass(frozen=True)
class KeySliceQuery:
    key: bytes
    slice: SliceQuery

    @property
    def start(self):
        return self.slice.start

    @property
    def end(self):
        return self.slice.end

    @property
    def limit(self):
        return self.slice.limit


@dataclass(frozen=True)
class KeyRangeQuery:
    """Key interval [key_start, key_end) × column slice, for ordered scans;
    ``key_end=None`` means unbounded above
    (reference: keycolumnvalue/KeyRangeQuery.java)."""
    key_start: bytes
    key_end: Optional[bytes]
    slice: SliceQuery
    key_limit: Optional[int] = None


@dataclass
class KCVMutation:
    """Additions + column deletions for one key.
    (reference: keycolumnvalue/KCVMutation.java)"""
    additions: list = field(default_factory=list)    # list[Entry]
    deletions: list = field(default_factory=list)    # list[bytes]

    def merge(self, other: "KCVMutation") -> None:
        self.additions.extend(other.additions)
        self.deletions.extend(other.deletions)

    @property
    def empty(self) -> bool:
        return not self.additions and not self.deletions

    def consolidate(self) -> None:
        """Last-write-wins per column; a deletion is overridden by a later
        addition of the same column (reference: Mutation.consolidate)."""
        added = {e.column: e for e in self.additions}
        self.additions = sorted(added.values())
        self.deletions = sorted(set(c for c in self.deletions if c not in added))


@dataclass(frozen=True)
class StoreFeatures:
    """Capability flags upper layers branch on.
    (reference: keycolumnvalue/StandardStoreFeatures.java)"""
    ordered_scan: bool = False
    unordered_scan: bool = False
    key_ordered: bool = False
    distributed: bool = False
    transactional: bool = False
    multi_query: bool = False
    locking: bool = False           # native store locking
    batch_mutation: bool = False
    local_key_partition: bool = False
    key_consistent: bool = False    # supports the consistent-read config needed
                                    # by id-authority/locking protocols
    persists: bool = True
    cell_ttl: bool = False
    timestamps: bool = False
    # packed bulk row IO (mutate_row_packed / scan_rows_packed): the
    # per-Entry SPI costs ~3-4us of host Python per cell, which
    # dominates benchmark-scale ingest and snapshot scans (measured
    # scale 22: 324s ingest + 238s scan through the entry-wise path);
    # stores that can move whole rows as (columns, values) byte-string
    # lists declare this and the bulk loader / snapshot scan use it
    packed_ops: bool = False

    @property
    def scan(self) -> bool:
        return self.ordered_scan or self.unordered_scan


class StoreTransaction:
    """Handle threaded through every store call.
    (reference: diskstorage/StoreTransaction.java + BaseTransactionConfig)"""

    def __init__(self, config: Optional["TransactionHandleConfig"] = None):
        self.config = config

    def commit(self) -> None:
        pass

    def rollback(self) -> None:
        pass


@dataclass
class TransactionHandleConfig:
    commit_time: Optional[int] = None     # microseconds since epoch
    group_name: Optional[str] = None
    custom: dict = field(default_factory=dict)


class KeyColumnValueStore(abc.ABC):
    """One named column family (reference:
    keycolumnvalue/KeyColumnValueStore.java:25)."""

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def get_slice(self, query: KeySliceQuery, txh: StoreTransaction) -> EntryList:
        """Entries of ``query.key`` with column in [start, end), ascending,
        capped at ``limit``."""

    def get_slice_multi(self, keys: Sequence[bytes], slice_query: SliceQuery,
                        txh: StoreTransaction) -> dict:
        """Default multi-key implementation loops; adapters with a native
        batched path override (features.multi_query)."""
        return {k: self.get_slice(KeySliceQuery(k, slice_query), txh) for k in keys}

    @abc.abstractmethod
    def mutate(self, key: bytes, additions: Sequence[Entry],
               deletions: Sequence[bytes], txh: StoreTransaction) -> None: ...

    def mutate_row_packed(self, key: bytes, columns: Sequence[bytes],
                          values: Sequence[bytes],
                          txh: StoreTransaction) -> None:
        """OPTIONAL bulk-row upsert (features.packed_ops): semantically
        identical to ``mutate(key, [Entry(c, v) ...], [])`` but takes
        parallel byte-string lists with ``columns`` PRE-SORTED ascending
        (the caller's contract), letting stores adopt whole fresh rows
        without per-Entry work. Ownership of the sequences TRANSFERS to
        the store — callers must not mutate them afterwards. Default:
        entry-wise fallback."""
        self.mutate(key, [Entry(c, v) for c, v in zip(columns, values)],
                    [], txh)

    def scan_rows_packed(self, txh: StoreTransaction) -> Iterator:
        """OPTIONAL full ordered scan yielding ``(key, columns, values)``
        with parallel byte-string lists instead of EntryLists
        (features.packed_ops) — the snapshot scan's bulk path. The
        yielded lists are READ-ONLY views of store internals; callers
        must not mutate them or write to the store while iterating.
        Default: adapt get_keys."""
        for key, entries in self.get_keys(SliceQuery(), txh):
            yield key, [e.column for e in entries], [e.value for e in entries]

    def acquire_lock(self, key: bytes, column: bytes, expected: Optional[bytes],
                     txh: StoreTransaction) -> None:
        raise NotImplementedError(f"store {self.name} has no native locking")

    @abc.abstractmethod
    def get_keys(self, query, txh: StoreTransaction) -> Iterator:
        """Iterate (key, EntryList) pairs. ``query`` is a KeyRangeQuery
        (ordered stores) or a bare SliceQuery (unordered scan); yields keys in
        byte order when features.key_ordered."""

    def close(self) -> None:
        pass


class KeyColumnValueStoreManager(abc.ABC):
    """Factory/registry for the named stores of one backend plus batched
    cross-store mutation (reference:
    keycolumnvalue/KeyColumnValueStoreManager.java:17)."""

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    @property
    @abc.abstractmethod
    def features(self) -> StoreFeatures: ...

    @abc.abstractmethod
    def open_database(self, name: str) -> KeyColumnValueStore: ...

    @abc.abstractmethod
    def begin_transaction(self, config: Optional[TransactionHandleConfig] = None
                          ) -> StoreTransaction: ...

    def mutate_many(self, mutations: dict, txh: StoreTransaction) -> None:
        """``mutations``: store name → {key: KCVMutation}. Default loops;
        adapters with an atomic batched RPC override (features.batch_mutation)."""
        for store_name, by_key in mutations.items():
            store = self.open_database(store_name)
            for key, m in by_key.items():
                store.mutate(key, m.additions, m.deletions, txh)

    def get_local_key_partition(self) -> Optional[list]:
        """[(start_key, end_key)] ranges hosted locally, when
        features.local_key_partition."""
        return None

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def clear_storage(self) -> None: ...

    def exists(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# helpers shared by adapters
# ---------------------------------------------------------------------------

def apply_slice(entries: Sequence[Entry], q: SliceQuery) -> EntryList:
    """Filter an ascending entry list to a slice query (adapter helper)."""
    out = []
    for e in entries:
        if q.end is not None and e.column >= q.end:
            break
        if e.column >= q.start:
            out.append(e)
            if q.limit is not None and len(out) >= q.limit:
                break
    return out
