"""Graph transaction: element caches, read-your-writes queries, commit.

Re-creation of the reference's transaction engine (reference: titan-core
graphdb/transaction/StandardTitanTx.java:83-1414 — per-tx vertex cache,
added/deleted relation sets, the ``edgeProcessor`` merge of stored slices
with in-tx deltas :1049-1122, commit/rollback :1344-1390) and the graph
commit path (graphdb/database/StandardTitanGraph.java prepareCommit
:493-616, commit :634-789): added/deleted relations re-serialize through the
deterministic edge codec into per-vertex-row mutation batches, flushed as one
batched backend call.

Constraint enforcement (reference: StandardTitanTx connectionEdges /
MultiplicityConstraint checks): SINGLE-cardinality properties replace the
previous value; SET rejects duplicates; unique edge directions
(MANY2ONE/ONE2ONE/ONE2MANY) reject a second edge; SIMPLE rejects parallel
edges.
"""

from __future__ import annotations

import threading
from typing import Any, Iterator, Optional

from titan_tpu_torch.core.defs import (Cardinality, Direction, ElementLifecycle,
                                 Multiplicity, RelationCategory)
from titan_tpu_torch.core.elements import Edge, Vertex, VertexProperty
from titan_tpu_torch.core.relations import InternalRelation
from titan_tpu_torch.errors import (InvalidElementError, SchemaViolationError,
                              TransactionClosedError)
from titan_tpu_torch.ids import IDType
from titan_tpu_torch.storage.api import Entry, KeySliceQuery, SliceQuery


_EMPTY_PROPS: Optional[bytes] = None


def _empty_props_bytes() -> bytes:
    """The codec's encoding of an empty edge property section (the uvar
    for count 0 — one 0x80 byte in the MSB-terminated varint scheme)."""
    global _EMPTY_PROPS
    if _EMPTY_PROPS is None:
        from titan_tpu_torch.codec.dataio import DataOutput
        out = DataOutput()
        out.put_uvar(0)
        _EMPTY_PROPS = out.getvalue()
    return _EMPTY_PROPS


def _values_equal(a: Any, b: Any) -> bool:
    """Property-value equality that tolerates ndarray values (whose ==
    broadcasts instead of answering)."""
    import numpy as np
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(a, b))
    return bool(a == b)


class GraphTransaction:
    def __init__(self, graph, read_only: bool = False,
                 log_identifier: Optional[str] = None):
        self.graph = graph
        self.schema = graph.schema
        self.codec = graph.codec
        self.idm = graph.idm
        self.read_only = read_only
        # trigger log: changes of this tx stream to ulog_<identifier>
        # (reference: docs/TitanBus.md:5-13, tx logIdentifier)
        self.log_identifier = log_identifier
        self._backend_tx = None
        self._open = True
        self._lock = threading.RLock()

        # caches & deltas
        self._vertices: dict[int, Vertex] = {}
        self._new_vertices: set[int] = set()
        self._removed_vertices: set[int] = set()
        self._vertex_labels: dict[int, int] = {}     # vid -> label schema id
        self._added: dict[int, InternalRelation] = {}        # rel id -> rel
        self._deleted: dict[int, InternalRelation] = {}      # rel id -> rel
        self._added_by_vertex: dict[int, list] = {}          # vid -> [rel]
        # per-vertex slice cache with query subsumption (reference:
        # CacheVertex — loaded EntryLists are reused within the tx; deltas
        # are merged on top by _iter_relations, so no invalidation needed)
        self._slice_cache: dict[bytes, list] = {}   # key -> [(SliceQuery, entries)]
        self._slice_cache_size = 0
        # parsed-adjacency cache: (vid, direction, type_ids) -> [Edge] for
        # the STORED part of the adjacency (deltas are merged per read).
        # The reference's tx vertex cache holds parsed relations, not raw
        # bytes (StandardTitanTx.java:83-1414 vertex cache + CacheVertex),
        # so repeated traversals over the same vertices skip the column
        # decode entirely; this is the analog for the batched DSL path.
        self._adj_cache: dict[tuple, list] = {}
        self._adj_cache_size = 0
        from titan_tpu_torch.config import defaults as _d
        self._slice_cache_cap = graph.config.get(_d.TX_CACHE_SIZE)
        self._fast_property = graph.config.get(_d.FAST_PROPERTY)
        from titan_tpu_torch.storage.locking import LockState
        self._lock_state = LockState()

    # ------------------------------------------------------------------ infra

    @property
    def backend_tx(self):
        if self._backend_tx is None:
            self._backend_tx = self.graph.backend.begin_transaction(
                index_txs=self.graph.open_index_txs())
        return self._backend_tx

    def _check_open(self):
        if not self._open:
            raise TransactionClosedError("transaction is closed")

    @property
    def is_open(self) -> bool:
        return self._open

    def edge_query(self, ksq) -> list:
        """Edgestore slice read through the per-tx vertex slice cache
        (reference: CacheVertex.loadRelations — an already-loaded slice that
        subsumes the request answers it without a backend call)."""
        cached = self._slice_cache.get(ksq.key)
        if cached is not None:
            for q, entries in cached:
                if q.subsumes(ksq.slice):
                    from titan_tpu_torch.storage.api import apply_slice
                    return apply_slice(entries, ksq.slice)
        entries = self.backend_tx.edge_store_query(ksq)
        if self._slice_cache_size < self._slice_cache_cap:
            self._slice_cache.setdefault(ksq.key, []).append((ksq.slice, entries))
            self._slice_cache_size += len(entries) + 1
        return entries

    def _multi_edge_query(self, keys, q) -> dict:
        """Batched multi-row slice read through the tx slice cache: cached
        rows answer locally, the rest go in ONE edge_store_multi_query."""
        from titan_tpu_torch.storage.api import apply_slice
        result: dict[bytes, list] = {}
        misses = []
        for kb in keys:
            hit = None
            for cq, entries in self._slice_cache.get(kb, ()):
                if cq.subsumes(q):
                    hit = apply_slice(entries, q)
                    break
            if hit is None:
                misses.append(kb)
            else:
                result[kb] = hit
        if misses:
            fetched = self.backend_tx.edge_store_multi_query(misses, q)
            result.update(fetched)
            for kb in misses:
                if self._slice_cache_size < self._slice_cache_cap:
                    entries = fetched.get(kb, [])
                    self._slice_cache.setdefault(kb, []).append((q, entries))
                    self._slice_cache_size += len(entries) + 1
        return result

    def vertex_handle(self, vid: int) -> Vertex:
        v = self._vertices.get(vid)
        if v is None:
            v = Vertex(self, vid)
            self._vertices[vid] = v
        return v

    def schema_name(self, type_id: int) -> str:
        name = self.schema.system.name_of(type_id)
        if name is not None:
            return name
        st = self.schema.get_type(type_id)
        if st is None:
            raise InvalidElementError(f"unknown schema id {type_id}")
        return st.name

    # ---------------------------------------------------------------- writes

    def add_vertex(self, label: Optional[str] = None, vertex_id: Optional[int] = None,
                   **props) -> Vertex:
        self._check_open()
        if self.read_only:
            raise SchemaViolationError("read-only transaction")
        label_type = None
        if label is not None:
            label_type = self.schema.get_or_create_vertex_label(label)
        if vertex_id is not None:
            if not self.graph.allow_custom_vid:
                raise SchemaViolationError(
                    "custom vertex ids disabled (graph.set-vertex-id)")
            vid = vertex_id
        else:
            idtype = IDType.NORMAL_VERTEX
            if label_type is not None and label_type.partitioned:
                idtype = IDType.PARTITIONED_VERTEX
            vid = self.graph.id_assigner.next_vertex_id(idtype=idtype)
            if idtype is IDType.PARTITIONED_VERTEX:
                # the user-visible id of a vertex-cut vertex is its CANONICAL
                # representative; system relations and properties live on the
                # canonical row, adjacency spreads over all representatives
                # (reference: IDManager.getCanonicalVertexId, vertex state at
                # the canonical copy)
                vid = self.idm.canonical_vertex_id(vid)
        v = self.vertex_handle(vid)
        self._new_vertices.add(vid)
        # existence marker (reference: BaseKey.VertexExists)
        self._add_relation(InternalRelation(
            self.graph.id_assigner.next_relation_id(),
            self.schema.system.vertex_exists, RelationCategory.PROPERTY,
            vid, value=True))
        if label_type is not None:
            self._vertex_labels[vid] = label_type.id
            self._add_relation(InternalRelation(
                self.graph.id_assigner.next_relation_id(),
                self.schema.system.vertex_label_edge, RelationCategory.EDGE,
                vid, label_type.id))
        for k, val in props.items():
            self.add_property(v, k, val)
        return v

    def _add_relation(self, rel: InternalRelation) -> InternalRelation:
        self._added[rel.relation_id] = rel
        for vid in rel.vertex_ids():
            if vid is not None and not self.idm.is_schema_id(vid):
                self._added_by_vertex.setdefault(vid, []).append(rel)
            elif vid is not None and self.idm.is_schema_id(vid):
                # vertex-label edges point at schema vertices; only the OUT
                # side materializes (labels don't list their members here)
                pass
        return rel

    def add_property(self, v: Vertex, key: str, value: Any) -> VertexProperty:
        self._check_open()
        if self.read_only:
            raise SchemaViolationError("read-only transaction")
        self._check_vertex_writable(v.id)
        pk = self.schema.get_or_create_key(key, value)
        value = self._validate_value(pk, key, value)
        if pk.cardinality is Cardinality.SINGLE:
            for p in self.vertex_properties(v.id, [key]):
                self.remove_relation(p.rel)
        elif pk.cardinality is Cardinality.SET:
            for p in self.vertex_properties(v.id, [key]):
                if _values_equal(p.rel.value, value):
                    return p  # set semantics: already present
        rel = self._add_relation(InternalRelation(
            self.graph.id_assigner.next_relation_id(), pk.id,
            RelationCategory.PROPERTY, v.id, value=value))
        return VertexProperty(self, rel)

    def add_meta_property(self, p: VertexProperty, key: str,
                          value: Any) -> VertexProperty:
        """Attach a meta-property to a vertex property (reference:
        TitanVertexProperty.property() — properties ON properties ride the
        owning relation's inline property map, like edge properties).

        Meta data is serialized inline with the owning relation, so a
        property LOADED from storage is rewritten: the old relation is
        deleted and re-added with the merged property map (same value,
        same key, new relation id) — matching the reference, where
        setting a property on a loaded TitanVertexProperty also rewrites
        the backing relation."""
        self._check_open()
        if self.read_only:
            raise SchemaViolationError("read-only transaction")
        pk = self.schema.get_or_create_key(key, value)
        value = self._validate_value(pk, key, value)
        if p.rel.relation_id in self._added:
            p.rel.properties[pk.id] = value
            return p
        old = p.rel
        self._check_vertex_writable(old.out_vertex_id)
        self.remove_relation(old)
        rel = InternalRelation(
            self.graph.id_assigner.next_relation_id(), old.type_id,
            RelationCategory.PROPERTY, old.out_vertex_id, value=old.value)
        rel.properties.update(old.properties)
        rel.properties[pk.id] = value
        self._add_relation(rel)
        # repoint the caller's handle at the rewritten relation so a second
        # add_meta_property on the same handle merges instead of rewriting
        # from the stale pre-rewrite relation (which would drop this meta)
        p.rel = rel
        return p

    def _validate_value(self, pk, key: str, value: Any) -> Any:
        """Enforce the key's declared dtype, coercing where lossless."""
        if pk.dtype is not None and not isinstance(value, pk.dtype):
            coerced = self._coerce(value, pk.dtype)
            if coerced is None:
                raise SchemaViolationError(
                    f"value {value!r} is not a {pk.dtype.__name__} "
                    f"(key {key!r})")
            value = coerced
        return value

    @staticmethod
    def _coerce(value, dtype):
        if dtype is float and isinstance(value, int):
            return float(value)
        if dtype is int and isinstance(value, bool):
            return None
        return None

    def add_edge(self, out_v: Vertex, label: str, in_v: Vertex,
                 props: Optional[dict] = None) -> Edge:
        self._check_open()
        if self.read_only:
            raise SchemaViolationError("read-only transaction")
        self._check_vertex_writable(out_v.id)
        self._check_vertex_writable(in_v.id)
        el = self.schema.get_or_create_label(label)
        self._check_multiplicity(el, out_v, in_v)
        rel = InternalRelation(
            self.graph.id_assigner.next_relation_id(), el.id,
            RelationCategory.EDGE, out_v.id, in_v.id)
        for k, val in (props or {}).items():
            pk = self.schema.get_or_create_key(k, val)
            rel.properties[pk.id] = self._validate_value(pk, k, val)
        self._add_relation(rel)
        return Edge(self, rel)

    def _check_multiplicity(self, el, out_v: Vertex, in_v: Vertex):
        mult = el.multiplicity
        if mult is Multiplicity.MULTI:
            return
        if mult.unique(Direction.OUT) or mult is Multiplicity.SIMPLE:
            for e in self.vertex_edges(out_v.id, Direction.OUT, [el.name]):
                if mult is not Multiplicity.SIMPLE or \
                        e.rel.other_vertex_id(out_v.id) == in_v.id:
                    raise SchemaViolationError(
                        f"multiplicity {mult.value} violated on {el.name!r} "
                        f"(existing out-edge)")
        if mult.unique(Direction.IN):
            for _ in self.vertex_edges(in_v.id, Direction.IN, [el.name]):
                raise SchemaViolationError(
                    f"multiplicity {mult.value} violated on {el.name!r} "
                    f"(existing in-edge)")

    def _check_vertex_writable(self, vid: int):
        if vid in self._removed_vertices:
            raise InvalidElementError(f"vertex {vid} was removed in this tx")
        # static vertex labels are immutable after the creating tx
        # (reference: VertexLabel.isStatic — required for vertex TTL, since
        # later writes would outlive the original cells)
        if vid not in self._new_vertices and self.idm.is_user_vertex_id(vid):
            self.vertex_label_name(vid)      # populate the label cache
            lid = self._vertex_labels.get(vid) or 0
            if lid:
                st = self.schema.get_type(lid)
                if st is not None and getattr(st, "static", False):
                    raise SchemaViolationError(
                        f"vertex {vid} has static label {st.name!r} and "
                        "cannot be modified after creation")

    def remove_relation(self, rel: InternalRelation) -> None:
        self._check_open()
        if self.read_only:
            raise SchemaViolationError("read-only transaction")
        # removing a relation modifies BOTH endpoint vertices — static
        # (immutable-after-creation) endpoints forbid it
        for vid in rel.vertex_ids():
            if vid is not None and not self.idm.is_schema_id(vid):
                self._check_vertex_writable(vid)
        if rel.relation_id in self._added:
            del self._added[rel.relation_id]
            for vid in rel.vertex_ids():
                if vid is not None and vid in self._added_by_vertex:
                    try:
                        self._added_by_vertex[vid].remove(rel)
                    except ValueError:
                        pass
        else:
            rel.lifecycle = ElementLifecycle.REMOVED
            self._deleted[rel.relation_id] = rel

    def remove_vertex(self, v: Vertex) -> None:
        self._check_open()
        if self.read_only:
            raise SchemaViolationError("read-only transaction")
        if v.id not in self._removed_vertices:
            self._check_vertex_writable(v.id)
        # delete every incident relation (incl. existence + label edge)
        for rel in list(self._iter_relations(v.id, Direction.BOTH, None,
                                             RelationCategory.RELATION,
                                             include_system=True)):
            self.remove_relation(rel)
        self._removed_vertices.add(v.id)
        self._new_vertices.discard(v.id)

    # ----------------------------------------------------------------- reads

    def vertex(self, vid: int) -> Optional[Vertex]:
        """Vertex by id, or None if it doesn't exist. A representative id of
        a vertex cut resolves to its canonical vertex."""
        self._check_open()
        if self.idm.is_partitioned_vertex(vid):
            vid = self.idm.canonical_vertex_id(vid)
        if vid in self._removed_vertices:
            return None
        if vid in self._new_vertices:
            return self.vertex_handle(vid)
        if not self.idm.is_user_vertex_id(vid):
            return None
        if self._vertex_exists(vid):
            return self.vertex_handle(vid)
        return None

    def _vertex_exists(self, vid: int) -> bool:
        [q] = self.codec.query_type(self.schema.system.vertex_exists,
                                    Direction.OUT, self.schema)
        entries = self.edge_query(KeySliceQuery(self.idm.key_bytes(vid), q))
        return bool(entries)

    def vertices(self) -> Iterator[Vertex]:
        """All vertices (full scan; reference: StandardTitanTx.java:1260-1282
        full-scan fallback)."""
        self._check_open()
        [q] = self.codec.query_type(self.schema.system.vertex_exists,
                                    Direction.OUT, self.schema)
        seen = set()
        for key, entries in self.backend_tx.edge_store_keys(q):
            if not entries:
                continue
            vid = self.idm.id_of_key_bytes(key)
            if not self.idm.is_user_vertex_id(vid):
                continue
            if vid in self._removed_vertices or vid in seen:
                continue
            seen.add(vid)
            yield self.vertex_handle(vid)
        for vid in sorted(self._new_vertices - seen):
            if vid not in self._removed_vertices:
                yield self.vertex_handle(vid)

    def vertex_label_name(self, vid: int) -> str:
        lid = self._vertex_labels.get(vid)
        if lid is None:
            for rel in self._iter_relations(vid, Direction.OUT, None,
                                            RelationCategory.EDGE,
                                            include_system=True):
                if rel.type_id == self.schema.system.vertex_label_edge:
                    lid = rel.in_vertex_id
                    break
            self._vertex_labels[vid] = lid if lid is not None else 0
        if not lid:
            return "vertex"
        st = self.schema.get_type(lid)
        return st.name if st else "vertex"

    def vertex_properties(self, vid: int, keys: Optional[list] = None
                          ) -> Iterator[VertexProperty]:
        self._check_open()
        type_ids = None
        if keys is not None:
            type_ids = []
            for k in keys:
                st = self.schema.get_by_name(k)
                if st is not None:
                    type_ids.append(st.id)
            if not type_ids:
                return
            if self._fast_property and vid not in self._new_vertices and \
                    self._slice_cache_size < self._slice_cache_cap:
                # property prefetch (reference: query.fast-property,
                # StandardTitanTx — load the whole property slice once so
                # subsequent single-key reads answer from the tx cache)
                self.edge_query(KeySliceQuery(
                    self.idm.key_bytes(vid),
                    self.codec.query_category(RelationCategory.PROPERTY,
                                              Direction.OUT,
                                              include_system=False)))
        for rel in self._iter_relations(vid, Direction.OUT, type_ids,
                                        RelationCategory.PROPERTY):
            yield VertexProperty(self, rel)

    def vertex_edges(self, vid: int, direction: Direction = Direction.BOTH,
                     labels: Optional[list] = None) -> Iterator[Edge]:
        self._check_open()
        type_ids = None
        if labels is not None:
            type_ids = []
            for name in labels:
                st = self.schema.get_by_name(name)
                if st is not None:
                    type_ids.append(st.id)
            if not type_ids:
                return
        for rel in self._iter_relations(vid, direction, type_ids,
                                        RelationCategory.EDGE):
            yield Edge(self, rel)

    # the edgeProcessor: merge stored slices with the tx delta
    def _iter_relations(self, vid: int, direction: Direction,
                        type_ids: Optional[list], category: RelationCategory,
                        include_system: bool = False) -> Iterator[InternalRelation]:
        emitted: set[tuple] = set()
        if vid not in self._new_vertices:
            for rel in self._stored_relations(vid, direction, type_ids,
                                              category, include_system):
                key = (rel.relation_id, rel.direction_of(vid) if rel.is_edge
                       else Direction.OUT)
                if rel.relation_id in self._deleted or key in emitted:
                    continue
                emitted.add(key)
                yield rel
        for rel in self._added_by_vertex.get(vid, ()):  # in-tx additions
            if not self._matches(rel, vid, direction, type_ids, category,
                                 include_system):
                continue
            key = (rel.relation_id,
                   rel.direction_of(vid) if rel.is_edge else Direction.OUT)
            if key in emitted:
                continue
            emitted.add(key)
            yield rel

    def _matches(self, rel: InternalRelation, vid: int, direction: Direction,
                 type_ids: Optional[list], category: RelationCategory,
                 include_system: bool) -> bool:
        if category is RelationCategory.EDGE and not rel.is_edge:
            return False
        if category is RelationCategory.PROPERTY and not rel.is_property:
            return False
        if type_ids is not None:
            if rel.type_id not in type_ids:
                return False
        elif not include_system and self.schema.system.is_system(rel.type_id):
            return False
        if rel.is_edge:
            d = rel.direction_of(vid)
            if direction is not Direction.BOTH and d is not direction:
                return False
        return True

    def _slices_for(self, direction, type_ids, category, include_system):
        if type_ids is not None:
            slices = []
            for tid in type_ids:
                slices.extend(self.codec.query_type(tid, direction, self.schema))
            return slices
        if category is RelationCategory.RELATION and include_system:
            return [self.codec.query_all()]
        return [self.codec.query_category(category, direction, include_system)]

    def _stored_relations(self, vid, direction, type_ids, category,
                          include_system) -> Iterator[InternalRelation]:
        # a vertex cut's adjacency is spread over ALL representative rows;
        # properties/system relations live on the canonical row only
        # (reference: OLTP reads fan out over getPartitionedVertexRepresentatives)
        if self.idm.is_partitioned_vertex(vid) and \
                category is not RelationCategory.PROPERTY:
            keys = [self.idm.key_bytes(r)
                    for r in self.idm.partitioned_vertex_representatives(vid)]
        else:
            keys = [self.idm.key_bytes(vid)]
        for q in self._slices_for(direction, type_ids, category, include_system):
            if len(keys) == 1:
                per_key = {keys[0]: self.edge_query(KeySliceQuery(keys[0], q))}
            else:
                # vertex cut: ONE batched multi-row read over all
                # representative rows instead of num_partitions point reads
                per_key = self._multi_edge_query(keys, q)
            for key in keys:
                for entry in per_key.get(key, ()):
                    rc = self.codec.parse(entry, self.schema)
                    rel = self._relation_from_cache(vid, rc)
                    if self._matches(rel, vid, direction, type_ids, category,
                                     include_system):
                        yield rel

    def _bulk_parse_out(self, items: list):
        """Vectorized decode of OUT-edge entries via the native codec
        (cites the same fast-shape rules as olap/tpu/snapshot._scan_native):
        returns a list aligned with ``items`` holding
        (relation_id, type_id, other_vertex_id) for entries of MULTI
        labels with no sort key and an empty property section (the value
        is exactly the codec's uvar encoding of property-count 0 — one
        0x80 byte in the MSB-terminated scheme, see
        _empty_props_bytes), and None where the per-entry parser must
        run. The port's native library is always built (a failed build
        raises)."""
        from titan_tpu_torch import native
        import numpy as np

        cols = bytearray()
        offs = [0]
        for _vid, e in items:
            cols += e.column
            offs.append(len(cols))
        col_buf = np.frombuffer(bytes(cols), dtype=np.uint8)
        offs_a = np.asarray(offs, dtype=np.int64)
        try:
            kind, tcount, dpos = native.parse_heads(col_buf, offs_a, b"")
        except ValueError:
            return None             # unknown head shape: per-entry parse
        fast_counts = []
        for c in np.unique(tcount[kind == native.KIND_OUT_EDGE]).tolist():
            tid = self.idm.schema_id(IDType.USER_EDGE_LABEL, int(c))
            if (self.schema.multiplicity(tid) is Multiplicity.MULTI
                    and not self.schema.sort_key(tid)):
                fast_counts.append(c)
        ends = offs_a[1:]
        mask = (kind == native.KIND_OUT_EDGE) \
            & np.isin(tcount, fast_counts)
        if mask.any():
            # empty-props check: the value section is exactly the uvar
            # encoding of property-count 0
            empty = _empty_props_bytes()
            vempty = np.fromiter((e.value == empty for _v, e in items),
                                 dtype=bool, count=len(items))
            mask &= vempty
        idx = np.flatnonzero(mask)
        if not len(idx):
            return None
        others, p2 = native.bulk_read_uvar(col_buf, dpos[idx], ends[idx])
        relids, _ = native.bulk_read_uvar(col_buf, p2, ends[idx])
        out: list = [None] * len(items)
        sid = self.idm.schema_id
        for k, j in enumerate(idx.tolist()):
            out[j] = (int(relids[k]),
                      sid(IDType.USER_EDGE_LABEL, int(tcount[j])),
                      int(others[k]))
        return out

    def _relation_from_cache(self, vid: int, rc) -> InternalRelation:
        if rc.category is RelationCategory.PROPERTY:
            return InternalRelation(rc.relation_id, rc.type_id, rc.category,
                                    vid, value=rc.value,
                                    properties=dict(rc.properties),
                                    lifecycle=ElementLifecycle.LOADED)
        if rc.direction is Direction.OUT:
            out_id, in_id = vid, rc.other_vertex_id
        else:
            out_id, in_id = rc.other_vertex_id, vid
        return InternalRelation(rc.relation_id, rc.type_id, rc.category,
                                out_id, in_id, properties=dict(rc.properties),
                                lifecycle=ElementLifecycle.LOADED)

    # multi-vertex batched adjacency (reference: TitanMultiVertexQuery /
    # edgeMultiQuery StandardTitanGraph.java:416-427)
    def multi_vertex_properties(self, vids: list,
                                keys: Optional[list] = None) -> dict:
        """``{vid: {key: value}}`` across many vertices with ONE batched
        property-slice read per slice query, instead of a point read per
        vertex (reference: TitanMultiVertexQuery properties() /
        optimize/TitanVertexStep.java:69-96 batch fill). Last parsed
        value per key wins — SINGLE-cardinality semantics matching
        ``Vertex.value``; multi-valued keys should use
        ``vertex_properties`` per vertex."""
        self._check_open()
        type_ids = None
        if keys is not None:
            type_ids = [st.id for k in keys
                        if (st := self.schema.get_by_name(k)) is not None]
            if not type_ids:
                return {vid: {} for vid in vids}
        out: dict[int, dict] = {vid: {} for vid in vids}
        kb: dict[bytes, int] = {}
        for v in set(vids):
            if v not in self._new_vertices:
                # properties live on the canonical row only (vertex cuts
                # fan out for EDGES, not properties — _stored_relations)
                kb[self.idm.key_bytes(v)] = v
        for q in self._slices_for(Direction.OUT, type_ids,
                                  RelationCategory.PROPERTY, False):
            if not kb:
                break
            result = self._multi_edge_query(list(kb), q)
            for key_bytes, entries in result.items():
                vid = kb[key_bytes]
                for entry in entries:
                    rc = self.codec.parse(entry, self.schema)
                    rel = self._relation_from_cache(vid, rc)
                    if rel.relation_id in self._deleted:
                        continue
                    if self._matches(rel, vid, Direction.OUT, type_ids,
                                     RelationCategory.PROPERTY, False):
                        out[vid][self.schema_name(rel.type_id)] = \
                            rel.value
        for vid in vids:                       # in-tx additions overlay
            for rel in self._added_by_vertex.get(vid, ()):
                if self._matches(rel, vid, Direction.OUT, type_ids,
                                 RelationCategory.PROPERTY, False):
                    out[vid][self.schema_name(rel.type_id)] = rel.value
        return out

    def multi_vertex_edges(self, vids: list, direction: Direction = Direction.BOTH,
                           labels: Optional[list] = None) -> dict:
        self._check_open()
        type_ids = None
        if labels is not None:
            type_ids = [st.id for name in labels
                        if (st := self.schema.get_by_name(name)) is not None]
            if not type_ids:
                return {vid: [] for vid in vids}
        out: dict[int, list] = {vid: [] for vid in vids}
        ckey = (direction, tuple(sorted(type_ids)) if type_ids else None)
        stored_vids = []
        seen_vids = set()
        for v in vids:
            if v in self._new_vertices or v in seen_vids:
                continue
            seen_vids.add(v)
            hit = self._adj_cache.get((v, *ckey))
            if hit is not None:
                # deletions made after the fill are filtered per read
                out[v] = ([e for e in hit
                           if e.rel.relation_id not in self._deleted]
                          if self._deleted else list(hit))
            else:
                stored_vids.append(v)
        keys: dict[bytes, int] = {}
        for v in stored_vids:
            if self.idm.is_partitioned_vertex(v):
                # vertex cut: one batched read covers every representative row
                for r in self.idm.partitioned_vertex_representatives(v):
                    keys[self.idm.key_bytes(r)] = v
            else:
                keys[self.idm.key_bytes(v)] = v
        stored: dict[int, list] = {v: [] for v in stored_vids}
        for q in self._slices_for(direction, type_ids, RelationCategory.EDGE,
                                  False):
            if not keys:
                break
            # answer cached keys from the tx slice cache; batch only the rest
            result = self._multi_edge_query(list(keys), q)
            items = [(keys[kb], e) for kb, entries in result.items()
                     for e in entries]
            # cold-path bulk decode: codec.parse per entry dominates the
            # first-touch 4-hop (measured ~60% of a cold LDBC query);
            # the native codec decodes the common shape (OUT edge,
            # MULTI label, no sort key, no properties) in two vectorized
            # sweeps, everything else falls back per entry
            bulk = self._bulk_parse_out(items) \
                if direction is Direction.OUT and len(items) >= 256 \
                else None
            for j, (vid, entry) in enumerate(items):
                fastrel = bulk[j] if bulk is not None else None
                if fastrel is not None:
                    relation_id, type_id, other = fastrel
                    rel = InternalRelation(
                        relation_id, type_id, RelationCategory.EDGE,
                        vid, other, properties={},
                        lifecycle=ElementLifecycle.LOADED)
                else:
                    rc = self.codec.parse(entry, self.schema)
                    rel = self._relation_from_cache(vid, rc)
                if self._matches(rel, vid, direction, type_ids,
                                 RelationCategory.EDGE, False):
                    stored[vid].append(Edge(self, rel))
        for vid in stored_vids:
            edges = stored[vid]
            # cap counts VERTICES, matching the reference's tx-cache-size
            # semantics (a vertex-count bound on the tx vertex cache)
            if self._adj_cache_size < self._slice_cache_cap:
                self._adj_cache[(vid, *ckey)] = edges
                self._adj_cache_size += 1
            out[vid] = ([e for e in edges
                         if e.rel.relation_id not in self._deleted]
                        if self._deleted else list(edges))
        for vid in dict.fromkeys(vids):     # dedup: out[vid] is shared
            for rel in self._added_by_vertex.get(vid, ()):
                if self._matches(rel, vid, direction, type_ids,
                                 RelationCategory.EDGE, False):
                    out[vid].append(Edge(self, rel))
        return out

    # ------------------------------------------------------ graph-centric query

    def query(self):
        """``tx.query().has(...)`` (reference: TitanTransaction.query())."""
        from titan_tpu_torch.query.graphquery import GraphQuery
        self._check_open()
        return GraphQuery(self)

    # ------------------------------------------------------------- lifecycle

    def commit(self) -> None:
        self._check_open()
        self.graph.count_tx("commit")
        try:
            if self._added or self._deleted:
                self.graph.commit_transaction(self)
            elif self._backend_tx is not None:
                self._backend_tx.commit()
        except BaseException:
            self.graph.count_tx("commit.exceptions")
            raise
        finally:
            self._open = False

    def rollback(self) -> None:
        if not self._open:
            return
        self.graph.count_tx("rollback")
        try:
            if self._backend_tx is not None:
                self._backend_tx.rollback()
        finally:
            self._open = False
            if self._lock_state.has_locks and \
                    self.graph.backend.locker is not None:
                self.graph.backend.locker.release_locks(self._lock_state)
        self._added.clear()
        self._deleted.clear()
        self._added_by_vertex.clear()

    def has_modifications(self) -> bool:
        return bool(self._added or self._deleted)
