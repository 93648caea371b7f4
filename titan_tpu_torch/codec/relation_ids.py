"""Relation-type column prefix codec.

Counterpart of the reference's IDHandler (reference: titan-core
graphdb/database/idhandling/IDHandler.java): every column in the edgestore
starts with the relation-type id and the relation's direction packed into one
order-relevant prefixed varint. Layout of the 3-bit prefix on the type count:

    [ system? : 1 bit (0 = system, sorts FIRST) | dir class : 2 bits ]

dir class: 0 = PROPERTY, 2 = EDGE_OUT, 3 = EDGE_IN (1 reserved).

System relation types sorting before all user types lets hot system slices
(vertex-exists checks, label lookups) use a tiny column range — the same
trick the reference plays with its type-id prefix ordering.

The encoded value is the TYPE COUNT (id with type/partition bits stripped),
so the column prefix stays short; direction bounds for a whole type come from
``slice_bounds``.
"""

from __future__ import annotations

from typing import Optional

from titan_tpu_torch.codec.dataio import DataOutput, ReadBuffer
from titan_tpu_torch.core.defs import Direction, RelationCategory
from titan_tpu_torch.ids import IDManager, IDType

PREFIX_BITS = 3

_DIR_PROPERTY = 0
_DIR_EDGE_OUT = 2
_DIR_EDGE_IN = 3


def _dir_code(category: RelationCategory, direction: Direction) -> int:
    if category is RelationCategory.PROPERTY:
        return _DIR_PROPERTY
    return _DIR_EDGE_OUT if direction is Direction.OUT else _DIR_EDGE_IN


def _prefix(type_id: int, idm: IDManager, category: RelationCategory,
            direction: Direction) -> int:
    system = idm.id_type(type_id).is_system
    return (0 if system else 4) | _dir_code(category, direction)


def write_relation_type(out: DataOutput, type_id: int, idm: IDManager,
                        category: RelationCategory, direction: Direction) -> None:
    count = idm.count(type_id)
    # keep the property/edge-label distinction in the low bit of the encoded
    # count so ids reconstruct exactly: [count | is_edge_label]
    is_edge = 1 if idm.id_type(type_id).is_edge_label else 0
    out.put_uvar_prefixed((count << 1) | is_edge,
                          _prefix(type_id, idm, category, direction), PREFIX_BITS)


def read_relation_type(buf: ReadBuffer, idm: IDManager) -> tuple[int, Direction,
                                                                 RelationCategory]:
    value, prefix = buf.get_uvar_prefixed(PREFIX_BITS)
    system = (prefix & 4) == 0
    dircode = prefix & 3
    count = value >> 1
    is_edge = value & 1
    if is_edge:
        idtype = IDType.SYSTEM_EDGE_LABEL if system else IDType.USER_EDGE_LABEL
    else:
        idtype = IDType.SYSTEM_PROPERTY_KEY if system else IDType.USER_PROPERTY_KEY
    type_id = idm.schema_id(idtype, count)
    if dircode == _DIR_PROPERTY:
        return type_id, Direction.OUT, RelationCategory.PROPERTY
    direction = Direction.OUT if dircode == _DIR_EDGE_OUT else Direction.IN
    return type_id, direction, RelationCategory.EDGE


def type_prefix(type_id: int, idm: IDManager, category: RelationCategory,
                direction: Direction) -> bytes:
    out = DataOutput()
    write_relation_type(out, type_id, idm, category, direction)
    return out.getvalue()


def _bound_bytes(prefix: int) -> tuple[bytes, Optional[bytes]]:
    """[start, end) byte range covering every varint with this 3-bit prefix.
    The prefix lives in the top bits of byte 0, so one-byte bounds suffice;
    the max prefix is unbounded above (None) — no finite sentinel can cover
    arbitrarily long encodings."""
    delta = 8 - PREFIX_BITS
    lo = bytes([prefix << delta])
    if prefix == (1 << PREFIX_BITS) - 1:
        hi = None
    else:
        hi = bytes([(prefix + 1) << delta])
    return lo, hi


def next_prefix(b: bytes) -> bytes:
    """Smallest byte string greater than every string having ``b`` as prefix."""
    arr = bytearray(b)
    while arr:
        if arr[-1] != 0xFF:
            arr[-1] += 1
            return bytes(arr)
        arr.pop()
    return b"\xff" * 17  # b was all 0xff: return a practical upper sentinel


def type_range(type_id: int, idm: IDManager, category: RelationCategory,
               direction: Direction) -> tuple[bytes, bytes]:
    """[start, end) column range holding every relation of one type+direction
    (valid because prefixed-varint encodings are prefix-free)."""
    p = type_prefix(type_id, idm, category, direction)
    return p, next_prefix(p)


def category_bounds(category: RelationCategory, direction: Direction = Direction.BOTH,
                    include_system: bool = True) -> tuple[bytes, bytes]:
    """Column range covering a whole relation category (for full-row slices
    filtered by kind, e.g. 'all properties' or 'all OUT edges')."""
    # prefixes ordered: system(0xx) then user(1xx); within: prop(0), out(2), in(3)
    def rng(system: bool):
        base = 0 if system else 4
        if category is RelationCategory.PROPERTY:
            return [_bound_bytes(base + _DIR_PROPERTY)]
        if category is RelationCategory.EDGE:
            if direction is Direction.OUT:
                return [_bound_bytes(base + _DIR_EDGE_OUT)]
            if direction is Direction.IN:
                return [_bound_bytes(base + _DIR_EDGE_IN)]
            return [(_bound_bytes(base + _DIR_EDGE_OUT)[0],
                     _bound_bytes(base + _DIR_EDGE_IN)[1])]
        # RELATION: everything in this system/user half
        return [(_bound_bytes(base + _DIR_PROPERTY)[0],
                 _bound_bytes(base + _DIR_EDGE_IN)[1])]

    ranges = (rng(True) if include_system else []) + rng(False)
    # single covering range (callers slice-filter within)
    return ranges[0][0], ranges[-1][1]
