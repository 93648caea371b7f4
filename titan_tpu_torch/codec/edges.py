"""The edge codec: relations ↔ edgestore columns/values.

Re-creation of the reference's EdgeSerializer contract (reference: titan-core
graphdb/database/EdgeSerializer.java — writeRelation :222-315, parseRelation
:73-166, getQuery slice bounds :363-475), with a format redesigned around two
needs of the TPU OLAP path: (a) the other-vertex id of an edge sits at a
fixed, varint-aligned position right after the (schema-known-length) sort
key, so bulk CSR extraction can decode columns without touching values in the
common case; (b) category/type grouping comes from the prefixed-varint
column head (codec/relation_ids.py).

Column / value layout per relation kind (␣ = concatenation):

  PROPERTY single   col [type]                         val [value][relid↩]
  PROPERTY set      col [type][ordered-value]          val [relid↩]
  PROPERTY list     col [type][relid uvar]             val [value]
  EDGE multi        col [type][sort][other][relid]     val [props]
  EDGE simple       col [type][sort][other]            val [props][relid↩]
  EDGE unique-dir   col [type]                         val [other][props][relid↩]
  EDGE other-dir*   col [type][sort][other]            val [props][relid↩]

  ↩ = backward varint peeled from the value's end; [type] = prefixed varint
  carrying (system?, dir-class, type count); [sort] = fixed-order-encoded
  sort-key values (schema-typed); [other] = other-vertex id uvar;
  * = the non-unique direction of MANY2ONE/ONE2MANY.

Uniqueness constraints are enforced by column collision: a unique direction's
column is just [type], so writing a second edge overwrites (or, with
locking, conflicts on) the first — the same mechanism the reference uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Protocol

from titan_tpu_torch.codec import relation_ids as rids
from titan_tpu_torch.codec.attributes import Serializer
from titan_tpu_torch.codec.dataio import DataOutput, ReadBuffer
from titan_tpu_torch.core.defs import Cardinality, Direction, Multiplicity, RelationCategory
from titan_tpu_torch.ids import IDManager
from titan_tpu_torch.storage.api import Entry, SliceQuery


class TypeInspector(Protocol):
    """Schema lookup the codec needs (reference: TypeInspector interface)."""

    def is_edge_label(self, type_id: int) -> bool: ...
    def data_type(self, key_id: int) -> type: ...
    def cardinality(self, key_id: int) -> Cardinality: ...
    def multiplicity(self, label_id: int) -> Multiplicity: ...
    def sort_key(self, label_id: int) -> tuple:  # tuple[int, ...] of key ids
        ...


@dataclass
class RelationCache:
    """Decoded relation (reference: graphdb/relations/RelationCache.java)."""
    relation_id: int
    type_id: int
    direction: Direction
    category: RelationCategory
    other_vertex_id: Optional[int] = None   # edges
    value: Any = None                       # properties
    properties: dict = field(default_factory=dict)  # key id -> value

    @property
    def is_edge(self) -> bool:
        return self.category is RelationCategory.EDGE


def _column_parts(multiplicity: Multiplicity, direction: Direction):
    """Which of (sort, other, relid) ride in the column for an edge."""
    if multiplicity is Multiplicity.MULTI:
        return True, True, True
    if multiplicity.unique(direction):
        return False, False, False
    return True, True, False


class EdgeCodec:
    def __init__(self, serializer: Serializer, idm: IDManager):
        self.serializer = serializer
        self.idm = idm

    # -- properties ----------------------------------------------------------

    def write_property(self, key_id: int, relation_id: int, value: Any,
                       inspector: TypeInspector,
                       properties: Optional[dict] = None) -> Entry:
        """``properties`` are META-properties (properties on the property —
        reference: TitanVertexProperty.property()); they ride the value as
        an optional trailing section, exactly like an edge's non-sort-key
        properties (EdgeSerializer.writeRelation's 'remaining properties').
        Omitted when empty, so rows without meta keep the legacy layout."""
        card = inspector.cardinality(key_id)
        col = DataOutput()
        rids.write_relation_type(col, key_id, self.idm,
                                 RelationCategory.PROPERTY, Direction.OUT)
        val = DataOutput()
        if card is Cardinality.SINGLE:
            self.serializer.write_value(val, value)
        elif card is Cardinality.SET:
            self._write_set_value(col, value, inspector.data_type(key_id))
        else:  # LIST
            col.put_uvar(relation_id)
            self.serializer.write_value(val, value)
        if properties:
            # same wire shape as an edge's non-sort-key properties
            self._write_props(val, key_id, properties, inspector,
                              skip_sort=False)
        if card is not Cardinality.LIST:
            val.put_uvar_backward(relation_id)
        return Entry(col.getvalue(), val.getvalue())

    # STORED-FORMAT FREEZE: the SET-value codec choice is part of the row
    # format. v1 shipped with exactly these dtypes on the order-preserving
    # codec; the serializer's orderable set has since widened (bool, UUID,
    # time), but flipping the codec for a dtype would silently misread
    # rows written before the widening — so the choice is pinned here and
    # may only change with a row-format version bump.
    def _set_value_ordered(self, dtype: type) -> bool:
        import datetime as _dt
        return dtype in (int, float, str, bytes, _dt.datetime, _dt.date,
                         _dt.timedelta)

    def _write_set_value(self, out: DataOutput, value: Any, dtype: type):
        # deterministic by declared dtype (write and read must agree):
        # frozen-orderable dtypes use the order-preserving codec, others
        # the self-describing one; uniqueness holds either way (same
        # value → same bytes)
        if self._set_value_ordered(dtype):
            self.serializer.write_ordered(out, value, dtype)
        else:
            self.serializer.write_value(out, value)

    # -- edges ---------------------------------------------------------------

    def write_edge(self, label_id: int, relation_id: int, direction: Direction,
                   other_vertex_id: int, inspector: TypeInspector,
                   properties: Optional[dict] = None) -> Entry:
        """Entry for ONE endpoint's row (call once per direction)."""
        assert direction in (Direction.OUT, Direction.IN)
        mult = inspector.multiplicity(label_id)
        sort_in_col, other_in_col, relid_in_col = _column_parts(mult, direction)
        properties = properties or {}

        col = DataOutput()
        rids.write_relation_type(col, label_id, self.idm,
                                 RelationCategory.EDGE, direction)
        if sort_in_col:
            self._write_sort_key(col, label_id, properties, inspector)
        if other_in_col:
            col.put_uvar(other_vertex_id)
        if relid_in_col:
            col.put_uvar(relation_id)

        val = DataOutput()
        if not other_in_col:
            val.put_uvar(other_vertex_id)
        self._write_props(val, label_id, properties, inspector,
                          skip_sort=sort_in_col)
        if not relid_in_col:
            val.put_uvar_backward(relation_id)
        return Entry(col.getvalue(), val.getvalue())

    def _write_sort_key(self, out: DataOutput, label_id: int, properties: dict,
                        inspector: TypeInspector):
        for key_id in inspector.sort_key(label_id):
            dtype = inspector.data_type(key_id)
            value = properties.get(key_id)
            out.put_u8(0 if value is None else 1)   # null marker keeps order
            if value is not None:
                self.serializer.write_ordered(out, value, dtype)

    def _write_props(self, out: DataOutput, label_id: int, properties: dict,
                     inspector: TypeInspector, skip_sort: bool):
        sort_ids = set(inspector.sort_key(label_id)) if skip_sort else set()
        items = [(k, v) for k, v in properties.items() if k not in sort_ids]
        out.put_uvar(len(items))
        for key_id, value in items:
            out.put_uvar(self.idm.count(key_id))
            self.serializer.write_value(out, value)

    # -- parsing -------------------------------------------------------------

    def parse(self, entry: Entry, inspector: TypeInspector) -> RelationCache:
        col = ReadBuffer(entry.column)
        type_id, direction, category = rids.read_relation_type(col, self.idm)
        if category is RelationCategory.PROPERTY:
            return self._parse_property(type_id, col, ReadBuffer(entry.value),
                                        inspector)
        return self._parse_edge(type_id, direction, col,
                                ReadBuffer(entry.value), inspector)

    def _parse_property(self, key_id: int, col: ReadBuffer, val: ReadBuffer,
                        inspector: TypeInspector) -> RelationCache:
        card = inspector.cardinality(key_id)
        if card is Cardinality.SINGLE:
            relation_id = val.get_uvar_backward_from_end()
            value = self.serializer.read_value(val)
        elif card is Cardinality.SET:
            relation_id = val.get_uvar_backward_from_end()
            dtype = inspector.data_type(key_id)
            if self._set_value_ordered(dtype):
                value = self.serializer.read_ordered(col, dtype)
            else:
                value = self.serializer.read_value(col)
        else:  # LIST
            relation_id = col.get_uvar()
            value = self.serializer.read_value(val)
        props: dict = {}
        if val.has_remaining():   # optional trailing meta-property section
            self._read_props(val, props)
        return RelationCache(relation_id, key_id, Direction.OUT,
                             RelationCategory.PROPERTY, value=value,
                             properties=props)

    def _parse_edge(self, label_id: int, direction: Direction, col: ReadBuffer,
                    val: ReadBuffer, inspector: TypeInspector) -> RelationCache:
        mult = inspector.multiplicity(label_id)
        sort_in_col, other_in_col, relid_in_col = _column_parts(mult, direction)
        props: dict = {}
        if sort_in_col:
            self._read_sort_key(col, label_id, inspector, props)
        if other_in_col:
            other = col.get_uvar()
        if relid_in_col:
            relation_id = col.get_uvar()
        else:
            relation_id = val.get_uvar_backward_from_end()
        if not other_in_col:
            other = val.get_uvar()
        self._read_props(val, props)
        return RelationCache(relation_id, label_id, direction,
                             RelationCategory.EDGE, other_vertex_id=other,
                             properties=props)

    def _read_sort_key(self, col: ReadBuffer, label_id: int,
                       inspector: TypeInspector, props: dict):
        for key_id in inspector.sort_key(label_id):
            if col.get_u8():
                props[key_id] = self.serializer.read_ordered(
                    col, inspector.data_type(key_id))

    def _read_props(self, val: ReadBuffer, props: dict):
        from titan_tpu_torch.ids import IDType
        n = val.get_uvar()
        for _ in range(n):
            count = val.get_uvar()
            key_id = self.idm.schema_id(IDType.USER_PROPERTY_KEY, count)
            props[key_id] = self.serializer.read_value(val)

    # -- slice bounds (reference: EdgeSerializer.getQuery) -------------------

    def query_all(self) -> SliceQuery:
        """Every relation on a vertex row."""
        return SliceQuery(b"", None)

    def query_category(self, category: RelationCategory,
                       direction: Direction = Direction.BOTH,
                       include_system: bool = True) -> SliceQuery:
        lo, hi = rids.category_bounds(category, direction, include_system)
        return SliceQuery(lo, hi)

    def query_type(self, type_id: int, direction: Direction,
                   inspector: TypeInspector,
                   sort_start: Optional[list] = None,
                   sort_end: Optional[list] = None) -> list[SliceQuery]:
        """Slice(s) for one relation type in one direction; BOTH yields two.
        sort_start/sort_end optionally narrow by a sort-key prefix interval."""
        category = (RelationCategory.EDGE if inspector.is_edge_label(type_id)
                    else RelationCategory.PROPERTY)
        dirs = [direction]
        if category is RelationCategory.EDGE and direction is Direction.BOTH:
            dirs = [Direction.OUT, Direction.IN]
        elif category is RelationCategory.PROPERTY:
            dirs = [Direction.OUT]
        out = []
        for d in dirs:
            prefix = rids.type_prefix(type_id, self.idm, category, d)
            lo, hi = prefix, rids.next_prefix(prefix)
            if category is RelationCategory.EDGE and \
                    _column_parts(inspector.multiplicity(type_id), d)[0]:
                if sort_start:
                    lo = prefix + self._sort_bytes(type_id, sort_start, inspector)
                if sort_end:
                    hi = prefix + self._sort_bytes(type_id, sort_end, inspector)
            out.append(SliceQuery(lo, hi))
        return out

    def _sort_bytes(self, label_id: int, values: list, inspector: TypeInspector
                    ) -> bytes:
        out = DataOutput()
        sort_ids = inspector.sort_key(label_id)
        for key_id, value in zip(sort_ids, values):
            out.put_u8(1)
            self.serializer.write_ordered(out, value,
                                          inspector.data_type(key_id))
        return out.getvalue()
