"""The mixed-index provider SPI.

(reference: titan-core diskstorage/indexing/IndexProvider.java:18-105 —
typed key registration, batched document mutations, condition-tree queries,
native raw queries, feature flags; IndexTransaction.java buffers mutations
per (store, docid) and flushes on commit.)

The port's copy of ``titan_tpu/indexing/provider.py``, plus the loader its
persistent providers read their pickles with (``load_pickle``): it admits
the port's classes and the schema's datatypes only, so an index directory
written by the JAX package fails loudly instead of importing
``titan_tpu``.
"""

from __future__ import annotations

import abc
import io
import pickle
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

from titan_tpu_torch.core.defs import Cardinality
from titan_tpu_torch.query.predicates import P


# -- the pickle loader -------------------------------------------------------

class _PortUnpickler(pickle.Unpickler):
    """Resolves the port's own classes and the schema's datatypes (the
    builtin ones included); every other global is refused."""

    def find_class(self, module, name):
        from titan_tpu_torch.core.schema import _DTYPES
        if module == "titan_tpu_torch" or \
                module.startswith("titan_tpu_torch."):
            return super().find_class(module, name)
        for t in _DTYPES.values():
            if t.__module__ == module and t.__qualname__ == name:
                return t
        raise pickle.UnpicklingError(
            f"index data names {module}.{name}; titan_tpu_torch loads only "
            "its own classes and the schema's datatypes (was this index "
            "directory written by another package?)")


def load_pickle(data):
    """``pickle.loads`` for bytes, ``pickle.load`` for a binary file, through
    the port's restricted unpickler."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = io.BytesIO(data)
    return _PortUnpickler(data).load()


# -- condition tree ----------------------------------------------------------

@dataclass(frozen=True)
class FieldCondition:
    field: str
    predicate: P

    def evaluate(self, doc: dict) -> bool:
        value = doc.get(self.field)
        if value is None:
            return False          # missing field never matches a predicate
        if isinstance(value, list):
            return any(self.predicate(v) for v in value)
        return self.predicate(value)


@dataclass(frozen=True)
class And:
    children: tuple

    def evaluate(self, doc: dict) -> bool:
        return all(c.evaluate(doc) for c in self.children)


@dataclass(frozen=True)
class Or:
    children: tuple

    def evaluate(self, doc: dict) -> bool:
        return any(c.evaluate(doc) for c in self.children)


@dataclass(frozen=True)
class Not:
    child: Any

    def evaluate(self, doc: dict) -> bool:
        return not self.child.evaluate(doc)


@dataclass(frozen=True)
class IndexQuery:
    """Condition tree + optional order/limit.
    (reference: diskstorage/indexing/IndexQuery.java)"""
    condition: Any
    orders: tuple = ()          # ((field, "asc"|"desc"), ...)
    limit: Optional[int] = None


@dataclass(frozen=True)
class RawQuery:
    """Provider-native query string (reference: indexing/RawQuery.java)."""
    query: str
    limit: Optional[int] = None
    offset: int = 0


@dataclass(frozen=True)
class KeyInformation:
    """What the provider needs to know about an indexed field.
    (reference: diskstorage/indexing/KeyInformation.java)"""
    dtype: type
    cardinality: Cardinality = Cardinality.SINGLE
    parameters: tuple = ()      # mapping hints, e.g. ("TEXT",) / ("STRING",)


@dataclass(frozen=True)
class IndexFeatures:
    """Capability flags the query planner branches on.
    (reference: diskstorage/indexing/IndexFeatures.java)"""
    supports_text: bool = True
    supports_geo: bool = True
    supports_numeric_range: bool = True
    supports_order: bool = True
    supports_raw_query: bool = False


# -- mutations ---------------------------------------------------------------

@dataclass
class IndexMutation:
    """Field changes for one document. ``deleted`` drops the whole doc.
    (reference: diskstorage/indexing/IndexMutation.java)"""
    additions: dict = field(default_factory=dict)   # field -> value
    deletions: set = field(default_factory=set)     # field names
    deleted: bool = False

    @property
    def empty(self) -> bool:
        return not self.additions and not self.deletions and not self.deleted


# -- SPI ---------------------------------------------------------------------

class IndexProvider(abc.ABC):
    name: str = "index"

    @property
    @abc.abstractmethod
    def features(self) -> IndexFeatures: ...

    @abc.abstractmethod
    def register(self, store: str, key: str, info: KeyInformation) -> None:
        """Declare a field before first use (type + mapping hints)."""

    @abc.abstractmethod
    def mutate(self, mutations: dict[str, dict[str, IndexMutation]]) -> None:
        """Apply {store -> {docid -> IndexMutation}} atomically-ish."""

    @abc.abstractmethod
    def query(self, store: str, query: IndexQuery) -> list[str]:
        """Doc ids matching a condition tree, ordered per query.orders."""

    def raw_query(self, store: str, query: RawQuery) -> list[tuple[str, float]]:
        """(docid, score) for a native query string."""
        raise NotImplementedError(f"{self.name} has no raw-query support")

    @abc.abstractmethod
    def close(self) -> None: ...

    def clear_storage(self) -> None:
        """Drop all documents (test helper)."""

    def drop_store(self, store: str) -> None:
        """Drop one index's documents (REMOVE_INDEX lifecycle)."""

    def begin_transaction(self) -> "IndexTransaction":
        return IndexTransaction(self)

    def supports(self, info: KeyInformation, predicate: P) -> bool:
        """Can this provider answer ``predicate`` on a field of this type +
        mapping? (reference: IndexProvider.supports — string fields follow
        their mapping: TEXT (default) answers tokenized text predicates,
        STRING answers exact/prefix/regex-on-whole-value predicates.)"""
        op = predicate.op
        f = self.features
        if info.dtype is str:
            string_mapped = "STRING" in info.parameters
            if op in ("textContains", "textPrefix", "textRegex"):
                return f.supports_text and not string_mapped
            if op in ("stringPrefix", "stringRegex"):
                return f.supports_text and string_mapped
            if op in ("eq", "neq", "within", "without"):
                return string_mapped
            return False
        try:
            from titan_tpu_torch.core.attribute import Geoshape
            if info.dtype is Geoshape:
                return f.supports_geo and op in (
                    "geoWithin", "geoIntersect", "geoDisjoint", "geoContains")
        except ImportError:
            pass
        if op in ("lt", "lte", "gt", "gte", "between", "inside"):
            return f.supports_numeric_range
        return op in ("eq", "neq", "within", "without")


class IndexTransaction:
    """Buffers document mutations; flushed on commit as ONE provider call.
    (reference: diskstorage/indexing/IndexTransaction.java)"""

    def __init__(self, provider: IndexProvider):
        self.provider = provider
        self._mutations: dict[str, dict[str, IndexMutation]] = {}

    def _m(self, store: str, docid: str) -> IndexMutation:
        return self._mutations.setdefault(store, {}).setdefault(
            docid, IndexMutation())

    def add(self, store: str, docid: str, field_name: str, value) -> None:
        m = self._m(store, docid)
        m.additions[field_name] = value
        m.deletions.discard(field_name)

    def delete(self, store: str, docid: str, field_name: str) -> None:
        m = self._m(store, docid)
        m.additions.pop(field_name, None)
        m.deletions.add(field_name)

    def delete_document(self, store: str, docid: str) -> None:
        m = self._m(store, docid)
        m.additions.clear()
        m.deletions.clear()
        m.deleted = True

    def register(self, store: str, key: str, info: KeyInformation) -> None:
        self.provider.register(store, key, info)

    def query(self, store: str, query: IndexQuery) -> list[str]:
        return self.provider.query(store, query)

    def raw_query(self, store: str, query: RawQuery):
        return self.provider.raw_query(store, query)

    def commit(self) -> None:
        if self._mutations:
            self.provider.mutate(self._mutations)
            self._mutations = {}

    def rollback(self) -> None:
        self._mutations = {}
