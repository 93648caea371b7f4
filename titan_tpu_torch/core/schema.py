"""Schema model, storage and cache.

Re-creation of the reference's schema-in-the-graph design (reference:
titan-core graphdb/types/ — TitanSchemaVertex, TypeDefinitionMap,
typemaker/*; cache in graphdb/database/cache/StandardSchemaCache.java):
schema elements ARE vertices. A schema vertex's row in the edgestore holds
its ~schemaname and ~typedefinition system properties; a system name index
row in the graphindex store maps name → id so lookups need one slice each
way. A process-wide SchemaCache fronts both directions.

Auto schema creation (the reference's DefaultSchemaMaker): unknown property
keys default to (type(value), SINGLE); unknown edge labels to MULTI.
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass, field as dc_field
from typing import Optional

from titan_tpu_torch.codec.attributes import Serializer
from titan_tpu_torch.codec.edges import EdgeCodec
from titan_tpu_torch.core.defs import Cardinality, Multiplicity, SchemaStatus
from titan_tpu_torch.core.system_types import SystemTypes
from titan_tpu_torch.errors import (SchemaNameExistsError,
                              SchemaViolationError,
                              TemporaryLockingError)
from titan_tpu_torch.storage.backend import INDEXSTORE_NAME
from titan_tpu_torch.storage.locking import LockID, LockState
from titan_tpu_torch.ids import IDManager, IDType
from titan_tpu_torch.storage.api import Entry, KeySliceQuery, SliceQuery

_NAME_INDEX_PREFIX = b"\x00sn\x00"   # system rows in graphindex
_INDEX_REGISTRY_KEY = b"\x00sidx\x00"   # column per index name -> schema id

# dtype registry: stored code <-> python type (extend via register_dtype)
_DTYPES: dict[str, type] = {}
_DTYPE_NAMES: dict[type, str] = {}


def register_dtype(name: str, t: type) -> None:
    _DTYPES[name] = t
    _DTYPE_NAMES[t] = name


import datetime as _dt
import uuid as _uuid

from titan_tpu_torch.core.attribute import Geoshape as _Geoshape

import decimal as _decimal

for _n, _t in [("bool", bool), ("int", int), ("float", float), ("str", str),
               ("bytes", bytes), ("uuid", _uuid.UUID), ("datetime", _dt.datetime),
               ("list", list), ("dict", dict), ("geoshape", _Geoshape),
               ("decimal", _decimal.Decimal), ("date", _dt.date),
               ("time", _dt.time), ("timedelta", _dt.timedelta),
               ("tuple", tuple), ("set", set), ("frozenset", frozenset)]:
    register_dtype(_n, _t)

import numpy as _np

register_dtype("ndarray", _np.ndarray)

import enum as _enum

# any Enum subclass maps to the base dtype (the serializer stores the
# concrete class path per value; reference: EnumSerializer)
register_dtype("enum", _enum.Enum)


@dataclass(frozen=True)
class SchemaType:
    id: int
    name: str

    @property
    def is_property_key(self) -> bool:
        return isinstance(self, PropertyKey)

    @property
    def is_edge_label(self) -> bool:
        return isinstance(self, EdgeLabel)

    @property
    def is_vertex_label(self) -> bool:
        return isinstance(self, VertexLabel)


@dataclass(frozen=True)
class PropertyKey(SchemaType):
    dtype: type = str
    cardinality: Cardinality = Cardinality.SINGLE
    status: SchemaStatus = SchemaStatus.ENABLED
    consistency: str = "none"   # none | lock (reference: ConsistencyModifier)
    ttl: float = 0.0            # seconds; 0 = never (reference: mgmt.setTTL)

    def definition(self) -> dict:
        return {"kind": "key", "dtype": _DTYPE_NAMES[self.dtype],
                "cardinality": self.cardinality.value,
                "status": self.status.value, "consistency": self.consistency,
                "ttl": self.ttl}


@dataclass(frozen=True)
class EdgeLabel(SchemaType):
    multiplicity: Multiplicity = Multiplicity.MULTI
    unidirected: bool = False
    sort_key: tuple = ()
    status: SchemaStatus = SchemaStatus.ENABLED
    consistency: str = "none"
    ttl: float = 0.0            # seconds; 0 = never (reference: mgmt.setTTL)

    def definition(self) -> dict:
        return {"kind": "label", "multiplicity": self.multiplicity.value,
                "unidirected": self.unidirected,
                "sort_key": list(self.sort_key), "status": self.status.value,
                "consistency": self.consistency, "ttl": self.ttl}


@dataclass(frozen=True)
class VertexLabel(SchemaType):
    partitioned: bool = False
    static: bool = False
    ttl: float = 0.0   # only meaningful for static labels (reference:
                       # vertex TTL requires a static vertex label)

    def definition(self) -> dict:
        return {"kind": "vertexlabel", "partitioned": self.partitioned,
                "static": self.static, "ttl": self.ttl}


@dataclass(frozen=True)
class IndexDefinition(SchemaType):
    """A graph index — composite (graphindex store) or mixed (external
    provider). (reference: graphdb/types/indextype/*, TitanGraphIndex in
    core/schema/ — indexes are schema vertices like everything else.)

    ``key_ids`` is ordered (composite row-key field order). ``key_params``
    aligns with it (mixed-index mapping hints, e.g. ``"TEXT"``/``"STRING"``).
    ``status`` drives the lifecycle: writes go to REGISTERED+ENABLED indexes,
    reads only use ENABLED ones (reference: SchemaStatus semantics).
    """
    element: str = "vertex"                     # vertex | edge
    composite: bool = True
    key_ids: tuple = ()
    key_params: tuple = ()
    unique: bool = False
    backing: str = ""                           # mixed: provider name
    index_only: int = 0                         # restrict to label/type id
    status: SchemaStatus = SchemaStatus.ENABLED

    def definition(self) -> dict:
        return {"kind": "index", "element": self.element,
                "composite": self.composite, "key_ids": list(self.key_ids),
                "key_params": list(self.key_params), "unique": self.unique,
                "backing": self.backing, "index_only": self.index_only,
                "status": self.status.value}

    @property
    def writable(self) -> bool:
        return self.status in (SchemaStatus.REGISTERED, SchemaStatus.ENABLED)

    @property
    def queryable(self) -> bool:
        return self.status is SchemaStatus.ENABLED


def _from_definition(schema_id: int, name: str, d: dict) -> SchemaType:
    kind = d["kind"]
    if kind == "key":
        return PropertyKey(schema_id, name, _DTYPES[d["dtype"]],
                           Cardinality(d["cardinality"]),
                           SchemaStatus(d.get("status", "enabled")),
                           d.get("consistency", "none"),
                           d.get("ttl", 0.0))
    if kind == "label":
        return EdgeLabel(schema_id, name, Multiplicity(d["multiplicity"]),
                         d.get("unidirected", False),
                         tuple(d.get("sort_key", ())),
                         SchemaStatus(d.get("status", "enabled")),
                         d.get("consistency", "none"),
                         d.get("ttl", 0.0))
    if kind == "vertexlabel":
        return VertexLabel(schema_id, name, d.get("partitioned", False),
                           d.get("static", False), d.get("ttl", 0.0))
    if kind == "index":
        return IndexDefinition(schema_id, name, d["element"], d["composite"],
                               tuple(d["key_ids"]), tuple(d["key_params"]),
                               d["unique"], d.get("backing", ""),
                               d.get("index_only", 0),
                               SchemaStatus(d.get("status", "enabled")))
    raise SchemaViolationError(f"unknown schema kind {kind!r}")


class SchemaManager:
    """Creates, stores, loads and caches schema types; implements the codec's
    TypeInspector protocol for BOTH system and user types."""

    def __init__(self, graph):
        self._graph = graph
        self.idm: IDManager = graph.idm
        self.serializer: Serializer = graph.serializer
        self.codec: EdgeCodec = graph.codec
        self.system = SystemTypes(self.idm)
        self._by_id: dict[int, SchemaType] = {}
        self._by_name: dict[str, int] = {}
        self._index_ids: Optional[list] = None   # cached registry row
        self._lock = threading.RLock()

    # -- TypeInspector protocol (codec callbacks) ----------------------------

    def is_edge_label(self, type_id: int) -> bool:
        t = self.idm.id_type(type_id)
        return t.is_edge_label

    def data_type(self, key_id: int) -> type:
        info = self.system.key_info(key_id)
        if info is not None:
            return info[1]
        st = self.get_type(key_id)
        assert isinstance(st, PropertyKey), key_id
        return st.dtype

    def cardinality(self, key_id: int) -> Cardinality:
        info = self.system.key_info(key_id)
        if info is not None:
            return info[2]
        st = self.get_type(key_id)
        assert isinstance(st, PropertyKey)
        return st.cardinality

    def multiplicity(self, label_id: int) -> Multiplicity:
        info = self.system.label_info(label_id)
        if info is not None:
            return info[1]
        st = self.get_type(label_id)
        assert isinstance(st, EdgeLabel)
        return st.multiplicity

    def sort_key(self, label_id: int) -> tuple:
        if self.system.label_info(label_id) is not None:
            return ()
        st = self.get_type(label_id)
        assert isinstance(st, EdgeLabel)
        return st.sort_key

    # -- lookup --------------------------------------------------------------

    def get_type(self, schema_id: int) -> Optional[SchemaType]:
        with self._lock:
            st = self._by_id.get(schema_id)
        if st is not None:
            return st
        st = self._load_by_id(schema_id)
        if st is not None:
            with self._lock:
                self._by_id[schema_id] = st
                self._by_name[st.name] = schema_id
        return st

    def get_by_name(self, name: str) -> Optional[SchemaType]:
        with self._lock:
            sid = self._by_name.get(name)
        if sid is not None:
            return self.get_type(sid)
        sid = self._load_name_index(name)
        if sid is None:
            return None
        return self.get_type(sid)

    def contains(self, name: str) -> bool:
        return self.get_by_name(name) is not None

    # -- creation ------------------------------------------------------------

    def make_property_key(self, name: str, dtype: type = str,
                          cardinality: Cardinality = Cardinality.SINGLE
                          ) -> PropertyKey:
        if dtype not in _DTYPE_NAMES:
            raise SchemaViolationError(f"unsupported dtype {dtype!r}")
        sid = self._graph.id_assigner.next_schema_id(IDType.USER_PROPERTY_KEY)
        return self._store_type(PropertyKey(sid, name, dtype, cardinality))

    def make_edge_label(self, name: str,
                        multiplicity: Multiplicity = Multiplicity.MULTI,
                        unidirected: bool = False,
                        sort_key: tuple = ()) -> EdgeLabel:
        for key_id in sort_key:
            if not isinstance(self.get_type(key_id), PropertyKey):
                raise SchemaViolationError("sort key must be property keys")
            if not self.serializer.orderable(self.data_type(key_id)):
                raise SchemaViolationError("sort key dtype must be orderable")
        sid = self._graph.id_assigner.next_schema_id(IDType.USER_EDGE_LABEL)
        return self._store_type(EdgeLabel(sid, name, multiplicity,
                                          unidirected, tuple(sort_key)))

    def make_vertex_label(self, name: str, partitioned: bool = False,
                          static: bool = False) -> VertexLabel:
        sid = self._graph.id_assigner.next_schema_id(IDType.VERTEX_LABEL)
        return self._store_type(VertexLabel(sid, name, partitioned, static))

    # auto schema maker (reference: DefaultSchemaMaker)
    def get_or_create_key(self, name: str, sample_value=None) -> PropertyKey:
        st = self.get_by_name(name)
        if st is not None:
            if not isinstance(st, PropertyKey):
                raise SchemaViolationError(f"{name!r} is not a property key")
            return st
        if self._graph.auto_schema is False:
            raise SchemaViolationError(f"unknown property key {name!r} "
                                       f"(auto schema disabled)")
        dtype = type(sample_value) if sample_value is not None else str
        if dtype not in _DTYPE_NAMES:
            # Enum FIRST (mirrors the serializer's handler_for): IntEnum/
            # StrEnum also pass isinstance(int/str) and the generic loop
            # would auto-create a primitive-typed key
            if isinstance(sample_value, _enum.Enum):
                dtype = _enum.Enum
            else:
                for base in _DTYPE_NAMES:
                    if isinstance(sample_value, base):
                        dtype = base
                        break
        return self._create_or_adopt(name, PropertyKey,
                                     lambda: self.make_property_key(name, dtype))

    def _create_or_adopt(self, name: str, kind: type, make):
        """Auto-schema creation that survives a racing creator (another
        thread or instance): if the create collides, adopt the winner.
        (reference: DefaultSchemaMaker under concurrent tx / the
        schema-broadcast path.)

        When the backend has a consistent-key locker, _store_type serializes
        creation on a name lock (reference closes the same window with
        consistent-key locks on the system name index), so a loser discovers
        the winner BEFORE any data is written under its id. Without a locker
        the claim-column protocol in _store_type still yields a deterministic
        winner; pre-creating schema (auto_schema=False) remains the guidance
        for locker-less eventually-consistent deployments."""
        st = None
        lock_exc: Optional[TemporaryLockingError] = None
        for attempt in range(5):
            try:
                st = make()
                break
            except SchemaNameExistsError:
                # only the collision case — other schema errors propagate
                self.expire(by_name=name)   # the peer's write made it stale
                st = self.get_by_name(name)
                break
            except TemporaryLockingError as e:
                # a racing creator holds the name lock and may not have
                # committed yet: poll for its write, else retry the creation
                lock_exc = e
                deadline = _time.monotonic() + 2.0
                while _time.monotonic() < deadline:
                    self.expire(by_name=name)
                    st = self.get_by_name(name)
                    if st is not None:
                        break
                    _time.sleep(0.02)
                if st is not None:
                    break
        if st is None:
            self.expire(by_name=name)
            st = self.get_by_name(name)
        if st is None and lock_exc is not None:
            # the lock never cleared (e.g. a crashed peer's claim outlives
            # it until lock expiry) and nothing was committed under the
            # name: surface the retriable condition, not a schema error
            raise lock_exc
        if st is None or not isinstance(st, kind):
            raise SchemaViolationError(
                f"{name!r} exists but is not a {kind.__name__}")
        return st

    def get_or_create_label(self, name: str) -> EdgeLabel:
        st = self.get_by_name(name)
        if st is not None:
            if not isinstance(st, EdgeLabel):
                raise SchemaViolationError(f"{name!r} is not an edge label")
            return st
        if self._graph.auto_schema is False:
            raise SchemaViolationError(f"unknown edge label {name!r}")
        return self._create_or_adopt(name, EdgeLabel,
                                     lambda: self.make_edge_label(name))

    def get_or_create_vertex_label(self, name: str) -> VertexLabel:
        st = self.get_by_name(name)
        if st is not None:
            if not isinstance(st, VertexLabel):
                raise SchemaViolationError(f"{name!r} is not a vertex label")
            return st
        if self._graph.auto_schema is False:
            raise SchemaViolationError(f"unknown vertex label {name!r}")
        return self._create_or_adopt(name, VertexLabel,
                                     lambda: self.make_vertex_label(name))

    def update_type(self, st: SchemaType) -> SchemaType:
        """Rewrite a type's definition (index lifecycle transitions etc.)."""
        return self._store_type(st, expect_new=False)

    def ttl_of(self, type_id: int) -> float:
        """Cell TTL (seconds) for relations of this type; 0 = never."""
        if self.system.is_system(type_id):
            return 0.0
        st = self.get_type(type_id)
        return getattr(st, "ttl", 0.0) if st is not None else 0.0

    # -- graph indexes -------------------------------------------------------

    def make_index(self, name: str, element: str, composite: bool,
                   key_ids: tuple, key_params: tuple = (),
                   unique: bool = False, backing: str = "",
                   index_only: int = 0,
                   status: SchemaStatus = SchemaStatus.ENABLED
                   ) -> IndexDefinition:
        for kid in key_ids:
            if not isinstance(self.get_type(kid), PropertyKey):
                raise SchemaViolationError("index keys must be property keys")
        if composite:
            for kid in key_ids:
                if not self.serializer.orderable(self.data_type(kid)):
                    raise SchemaViolationError(
                        "composite index keys need byte-ordered dtypes")
        if unique and (not composite or element != "vertex"):
            raise SchemaViolationError(
                "uniqueness requires a composite vertex index")
        if not key_params:
            key_params = ("DEFAULT",) * len(key_ids)
        sid = self._graph.id_assigner.next_schema_id(IDType.GENERIC_SCHEMA)
        idx = self._store_type(IndexDefinition(
            sid, name, element, composite, tuple(key_ids), tuple(key_params),
            unique, backing, index_only, status))
        self._register_index(idx)
        return idx

    def _register_index(self, idx: IndexDefinition) -> None:
        backend = self._graph.backend
        txh = backend.manager.begin_transaction()
        try:
            backend.index_store.store.mutate(
                _INDEX_REGISTRY_KEY,
                [Entry(idx.name.encode("utf-8"), idx.id.to_bytes(8, "big"))],
                [], txh)
            txh.commit()
        except BaseException:
            txh.rollback()
            raise
        with self._lock:
            self._index_ids = None
        backend.index_store.invalidate(_INDEX_REGISTRY_KEY)

    def indexes(self, element: Optional[str] = None) -> list:
        """All graph indexes (optionally only vertex/edge ones)."""
        with self._lock:
            ids = self._index_ids
        if ids is None:
            backend = self._graph.backend
            txh = backend.manager.begin_transaction()
            try:
                entries = backend.index_store.store.get_slice(
                    KeySliceQuery(_INDEX_REGISTRY_KEY, SliceQuery()), txh)
            finally:
                txh.commit()
            ids = [int.from_bytes(e.value, "big") for e in entries]
            with self._lock:
                self._index_ids = ids
        out = []
        for iid in ids:
            idx = self.get_type(iid)
            if isinstance(idx, IndexDefinition) and \
                    (element is None or idx.element == element):
                out.append(idx)
        return out

    def indexes_for_key(self, key_id: int, element: str) -> list:
        return [ix for ix in self.indexes(element) if key_id in ix.key_ids]

    # -- storage -------------------------------------------------------------

    def _name_index_key(self, name: str) -> bytes:
        return _NAME_INDEX_PREFIX + name.encode("utf-8")

    def all_types(self) -> list:
        """Every declared user schema type, loaded from the name index
        (reference: ManagementSystem.getRelationTypes/getVertexLabels)."""
        backend = self._graph.backend
        from titan_tpu_torch.storage.api import KeyRangeQuery
        lo = _NAME_INDEX_PREFIX
        hi = _NAME_INDEX_PREFIX[:-1] + \
            bytes([_NAME_INDEX_PREFIX[-1] + 1])
        txh = backend.manager.begin_transaction()
        out = []
        try:
            for key, entries in backend.index_store.store.get_keys(
                    KeyRangeQuery(lo, hi, SliceQuery()), txh):
                if entries:
                    # first claim column = smallest id = the winner
                    # (legacy rows carry the id in the value instead)
                    first = entries[0]
                    sid = int.from_bytes(
                        first.value if len(first.column) == 1
                        else first.column, "big")
                    st = self.get_type(sid)
                    if st is not None:
                        out.append(st)
        finally:
            txh.commit()
        return sorted(out, key=lambda t: t.id)

    def _store_type(self, st: SchemaType, expect_new: bool = True) -> SchemaType:
        if expect_new and self.get_by_name(st.name) is not None:
            raise SchemaNameExistsError(
                f"schema name already exists: {st.name!r}")
        backend = self._graph.backend
        locker = getattr(backend, "locker", None)
        lock_state = None
        if expect_new and locker is not None:
            # Lock-backed creation (reference: consistent-key locking on the
            # system name index): serialize creators of the same name so the
            # loser learns of the winner BEFORE writing data under its id.
            lock_state = LockState()
            locker.write_lock(
                LockID(INDEXSTORE_NAME, self._name_index_key(st.name),
                       b"\x00sc"),
                lock_state)
            try:
                winner = self._load_name_index(st.name)
            except BaseException:
                locker.release_locks(lock_state)
                raise
            if winner is not None:
                # a racing creator committed before our lock claim landed
                locker.release_locks(lock_state)
                self.expire(by_name=st.name)
                raise SchemaNameExistsError(
                    f"schema name already exists: {st.name!r}")
        try:
            return self._store_type_locked(st, expect_new)
        finally:
            if lock_state is not None:
                locker.release_locks(lock_state)

    def _store_type_locked(self, st: SchemaType,
                           expect_new: bool) -> SchemaType:
        backend = self._graph.backend
        txh = backend.manager.begin_transaction()
        try:
            key = self.idm.key_bytes(st.id)
            name_entry = self.codec.write_property(
                self.system.schema_name, self._graph.id_assigner.next_relation_id(),
                st.name, self)
            def_entry = self.codec.write_property(
                self.system.type_definition,
                self._graph.id_assigner.next_relation_id(),
                st.definition(), self)
            backend.edge_store.store.mutate(key, [name_entry, def_entry], [], txh)
            # name-index entries are CLAIM COLUMNS keyed by the schema id;
            # concurrent creators of the same name each write their own
            # column and the smallest id deterministically wins (reference:
            # the ConsistentKeyIDAuthority claim protocol shape) — no
            # last-write-wins divergence between racing instances
            backend.index_store.store.mutate(
                self._name_index_key(st.name),
                [Entry(st.id.to_bytes(8, "big"), b"")], [], txh)
            txh.commit()
        except BaseException:
            txh.rollback()
            raise
        if expect_new:
            # re-read: did a racing creator's smaller id win the name?
            winner_id = self._load_name_index(st.name)
            if winner_id is not None and winner_id != st.id:
                winner = self.get_type(winner_id)
                if winner is not None:
                    with self._lock:
                        self._by_name[st.name] = winner_id
                    return winner
        with self._lock:
            self._by_id[st.id] = st
            self._by_name[st.name] = st.id
        backend.edge_store.invalidate(self.idm.key_bytes(st.id))
        return st

    def _load_name_index(self, name: str) -> Optional[int]:
        backend = self._graph.backend
        txh = backend.manager.begin_transaction()
        try:
            entries = backend.index_store.store.get_slice(
                KeySliceQuery(self._name_index_key(name), SliceQuery()), txh)
        finally:
            txh.commit()
        if not entries:
            return None
        first = entries[0]
        if len(first.column) == 1:
            # legacy layout (pre-claim-column): fixed 1-byte column, id in
            # the VALUE. It predates any claim, so it IS the winner; upgrade
            # the row in place so future readers take the claim path.
            legacy_id = int.from_bytes(first.value, "big")
            try:
                txh2 = backend.manager.begin_transaction()
                backend.index_store.store.mutate(
                    self._name_index_key(name),
                    [Entry(legacy_id.to_bytes(8, "big"), b"")],
                    [first.column], txh2)
                txh2.commit()
            except Exception:
                pass   # reads still work off the legacy row
            return legacy_id
        # columns are big-endian id claims; ascending column order makes the
        # first entry the smallest id — the deterministic winner
        return int.from_bytes(first.column, "big")

    def _load_by_id(self, schema_id: int) -> Optional[SchemaType]:
        if not self.idm.is_schema_id(schema_id):
            return None
        backend = self._graph.backend
        txh = backend.manager.begin_transaction()
        try:
            entries = backend.edge_store.store.get_slice(
                KeySliceQuery(self.idm.key_bytes(schema_id), SliceQuery()), txh)
        finally:
            txh.commit()
        name = None
        definition = None
        for e in entries:
            rc = self.codec.parse(e, self)
            if rc.type_id == self.system.schema_name:
                name = rc.value
            elif rc.type_id == self.system.type_definition:
                definition = rc.value
        if name is None or definition is None:
            return None
        return _from_definition(schema_id, name, definition)

    def expire(self, schema_id: Optional[int] = None,
               by_name: Optional[str] = None) -> None:
        with self._lock:
            self._index_ids = None
            if by_name is not None:
                sid = self._by_name.pop(by_name, None)
                if sid is not None:
                    self._by_id.pop(sid, None)
                return
            if schema_id is None:
                self._by_id.clear()
                self._by_name.clear()
            else:
                st = self._by_id.pop(schema_id, None)
                if st is not None:
                    self._by_name.pop(st.name, None)
