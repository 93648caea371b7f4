"""IndexSerializer: composite-index row codec + mixed-index document mapping
+ per-transaction index-update collection.

(reference: titan-core graphdb/database/IndexSerializer.java:784 —
``getIndexUpdates`` collects IndexUpdate records from a transaction's
added/deleted relations; composite row key = [index id][byte-ordered key
values]; row columns = one per matching element; mixed indexes map elements
to documents keyed by element id.)

Composite semantics mirrored from the reference:
* an element is recorded under an index only when it has a value for EVERY
  indexed key (all-keys-present rule);
* a multi-key composite index requires SINGLE cardinality on all keys; a
  single-key index on a SET/LIST key yields one entry per value;
* writes go to indexes whose status is REGISTERED or ENABLED, queries only
  use ENABLED indexes.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product
from typing import Iterable, Optional

from titan_tpu_torch.codec.dataio import DataOutput, ReadBuffer
from titan_tpu_torch.core.defs import Cardinality
from titan_tpu_torch.core.schema import IndexDefinition
from titan_tpu_torch.errors import SchemaViolationError
from titan_tpu_torch.storage.api import Entry, KeySliceQuery, SliceQuery


@dataclass(frozen=True)
class IndexUpdate:
    """One pending index mutation.

    ``composite``: store row mutation for the graphindex store —
    ``key``/``entry`` set, deletion when ``addition`` is False.
    ``mixed``: document field change routed to an IndexTransaction —
    ``index_name``/``docid``/``field``/``value`` set (value None = delete
    field).
    """
    index: IndexDefinition
    addition: bool
    # composite:
    key: Optional[bytes] = None
    entry: Optional[Entry] = None
    # mixed:
    docid: Optional[str] = None
    field: Optional[str] = None
    value: object = None


class IndexSerializer:
    def __init__(self, serializer, idm, schema):
        self.serializer = serializer
        self.idm = idm
        self.schema = schema

    # -- composite row codec -------------------------------------------------

    def composite_row_key(self, index: IndexDefinition,
                          values: Iterable) -> bytes:
        out = DataOutput()
        out.put_uvar(index.id)
        for kid, value in zip(index.key_ids, values):
            self.serializer.write_ordered(out, value,
                                          self.schema.data_type(kid))
        return out.getvalue()

    def vertex_column(self, vid: int) -> bytes:
        return vid.to_bytes(8, "big")

    def edge_column(self, rel) -> bytes:
        out = DataOutput()
        out.put_uvar(rel.relation_id)
        out.put_u64(rel.out_vertex_id)
        out.put_u64(rel.in_vertex_id)
        out.put_uvar(rel.type_id)
        return out.getvalue()

    @staticmethod
    def parse_vertex_column(column: bytes) -> int:
        return int.from_bytes(column, "big")

    @staticmethod
    def parse_edge_column(column: bytes) -> tuple:
        """→ (relation_id, out_vid, in_vid, type_id)"""
        buf = ReadBuffer(column)
        rid = buf.get_uvar()
        out_vid = buf.get_u64()
        in_vid = buf.get_u64()
        tid = buf.get_uvar()
        return rid, out_vid, in_vid, tid

    # -- document mapping (mixed) -------------------------------------------

    @staticmethod
    def docid_for(element_id: int) -> str:
        return format(element_id, "x")

    @staticmethod
    def element_id_of(docid: str) -> int:
        return int(docid, 16)

    # -- update collection (the getIndexUpdates equivalent) ------------------

    def _label_ttl(self, tx, vid: int) -> float:
        lid = tx._vertex_labels.get(vid) or 0
        if not lid:
            return 0.0
        st = self.schema.get_type(lid)
        return getattr(st, "ttl", 0.0) if st else 0.0

    def _composite_entry(self, tx, column: bytes, ix, vid=None, rel=None):
        """Composite index entry, TTL'd to match its element so expired
        elements don't leave permanent ghost rows (reference: prepareCommit
        attaches the element TTL to index-store entries too)."""
        ttls = [self.schema.ttl_of(kid) for kid in ix.key_ids]
        if vid is not None:
            ttls.append(self._label_ttl(tx, vid))
        if rel is not None:
            ttls.append(self.schema.ttl_of(rel.type_id))
            ttls.append(self._label_ttl(tx, rel.out_vertex_id))
            ttls.append(self._label_ttl(tx, rel.in_vertex_id))
        live = [t for t in ttls if t > 0]
        if not live:
            return Entry(column, b"")
        from titan_tpu_torch.storage.api import TTLEntry
        return TTLEntry(column, b"", min(live))

    def collect_updates(self, tx) -> list[IndexUpdate]:
        """Index updates implied by a transaction's added/deleted relations."""
        updates: list[IndexUpdate] = []
        self._vertex_updates(tx, updates)
        self._edge_updates(tx, updates)
        return updates

    # vertices: find (vid, key) pairs whose property set changed, then for
    # every writable index containing an affected key emit delete(pre-tuple)
    # + add(post-tuple) when the all-keys-present rule holds on that side.
    def _vertex_updates(self, tx, updates: list[IndexUpdate]) -> None:
        affected: dict[int, set] = {}   # vid -> {key id}
        for rel in list(tx._added.values()) + list(tx._deleted.values()):
            if not rel.is_property:
                continue
            if self.schema.system.is_system(rel.type_id):
                continue
            affected.setdefault(rel.out_vertex_id, set()).add(rel.type_id)
        if not affected:
            return

        vertex_indexes = [ix for ix in self.schema.indexes("vertex")
                          if ix.writable]
        for vid, keys in affected.items():
            if not self.idm.is_user_vertex_id(vid):
                continue
            removed = vid in tx._removed_vertices
            new = vid in tx._new_vertices
            label_id = None   # resolved lazily for index_only checks
            for ix in vertex_indexes:
                if not keys & set(ix.key_ids):
                    continue
                if ix.index_only:
                    if label_id is None:
                        label_id = self._label_id(tx, vid)
                    if label_id != ix.index_only:
                        continue
                pre = None if new else \
                    self._value_tuples(tx, vid, ix, "pre")
                post = None if removed else \
                    self._value_tuples(tx, vid, ix, "post")
                if ix.composite:
                    col = self.vertex_column(vid)
                    for vals in (pre or ()):
                        if post and vals in post:
                            continue   # unchanged tuple: no churn
                        updates.append(IndexUpdate(
                            ix, False,
                            key=self.composite_row_key(ix, vals),
                            entry=Entry(col, b"")))
                    for vals in (post or ()):
                        if pre and vals in pre:
                            continue
                        updates.append(IndexUpdate(
                            ix, True,
                            key=self.composite_row_key(ix, vals),
                            entry=self._composite_entry(tx, col, ix,
                                                        vid=vid)))
                else:
                    docid = self.docid_for(vid)
                    for kid in keys & set(ix.key_ids):
                        key_name = self.schema.get_type(kid).name
                        post_vals = None if removed else \
                            self._key_values(tx, vid, kid, "post")
                        value = post_vals[0] if post_vals else None
                        card = self.schema.cardinality(kid)
                        if card is not Cardinality.SINGLE and post_vals:
                            value = list(post_vals)
                        updates.append(IndexUpdate(
                            ix, value is not None, docid=docid,
                            field=key_name, value=value))

    def _label_id(self, tx, vid: int) -> int:
        from titan_tpu_torch.core.defs import Direction, RelationCategory
        for rel in tx._iter_relations(vid, Direction.OUT, None,
                                      RelationCategory.EDGE,
                                      include_system=True):
            if rel.type_id == self.schema.system.vertex_label_edge:
                return rel.in_vertex_id
        return 0

    # edges: added/deleted edge relations carry their properties inline
    def _edge_updates(self, tx, updates: list[IndexUpdate]) -> None:
        edge_indexes = [ix for ix in self.schema.indexes("edge")
                        if ix.writable]
        if not edge_indexes:
            return
        for rel, addition in ([(r, True) for r in tx._added.values()] +
                              [(r, False) for r in tx._deleted.values()]):
            if not rel.is_edge or self.schema.system.is_system(rel.type_id):
                continue
            for ix in edge_indexes:
                if ix.index_only and rel.type_id != ix.index_only:
                    continue
                vals = []
                for kid in ix.key_ids:
                    if kid not in rel.properties:
                        break
                    vals.append(rel.properties[kid])
                else:
                    if ix.composite:
                        col_e = self.edge_column(rel)
                        entry = self._composite_entry(tx, col_e, ix,
                                                      rel=rel) \
                            if addition else Entry(col_e, b"")
                        updates.append(IndexUpdate(
                            ix, addition,
                            key=self.composite_row_key(ix, vals),
                            entry=entry))
                    else:
                        docid = self.docid_for(rel.relation_id)
                        for kid, value in zip(ix.key_ids, vals):
                            updates.append(IndexUpdate(
                                ix, addition, docid=docid,
                                field=self.schema.get_type(kid).name,
                                value=value if addition else None))

    # -- pre/post value reconstruction --------------------------------------

    def _key_values(self, tx, vid: int, key_id: int, when: str) -> list:
        """Values of ``key_id`` on ``vid`` before ("pre") or after ("post")
        the transaction. Post is the tx-visible view; pre is post with the
        tx's additions removed and deletions restored."""
        from titan_tpu_torch.core.defs import Direction, RelationCategory
        post = [rel.value
                for rel in tx._iter_relations(vid, Direction.OUT, [key_id],
                                              RelationCategory.PROPERTY)]
        if when == "post":
            return post
        pre = list(post)
        for rel in tx._added.values():
            if rel.is_property and rel.type_id == key_id and \
                    rel.out_vertex_id == vid and rel.value in pre:
                pre.remove(rel.value)
        for rel in tx._deleted.values():
            if rel.is_property and rel.type_id == key_id and \
                    rel.out_vertex_id == vid:
                pre.append(rel.value)
        return pre

    def _value_tuples(self, tx, vid: int, ix: IndexDefinition,
                      when: str) -> list[tuple]:
        """All indexed value tuples for a vertex (cartesian product over
        multi-valued keys; empty list when any key is absent)."""
        per_key = []
        for kid in ix.key_ids:
            vals = self._key_values(tx, vid, kid, when)
            if not vals:
                return []
            if len(vals) > 1 and len(ix.key_ids) > 1:
                raise SchemaViolationError(
                    f"multi-key composite index {ix.name!r} requires SINGLE "
                    f"cardinality keys")
            per_key.append(vals)
        return [tuple(p) for p in product(*per_key)]

    # -- provider field registration ------------------------------------------

    def register_keys(self, provider, index: IndexDefinition) -> None:
        """Replay a mixed index's field registrations onto its provider
        (used at build time and when reindexing on a fresh provider)."""
        from titan_tpu_torch.indexing.provider import KeyInformation
        for kid, param in zip(index.key_ids, index.key_params):
            pk = self.schema.get_type(kid)
            provider.register(index.name, pk.name, KeyInformation(
                pk.dtype, pk.cardinality,
                (param,) if param != "DEFAULT" else ()))

    # -- composite query ------------------------------------------------------

    def query_composite(self, backend_tx, ix: IndexDefinition,
                        values: Iterable, limit: Optional[int] = None) -> list:
        """Element ids (vertex ids, or edge column tuples) matching an
        equality tuple on a composite index."""
        row = self.composite_row_key(ix, values)
        entries = backend_tx.index_query(
            KeySliceQuery(row, SliceQuery(limit=limit)))
        if ix.element == "vertex":
            return [self.parse_vertex_column(e.column) for e in entries]
        return [self.parse_edge_column(e.column) for e in entries]
