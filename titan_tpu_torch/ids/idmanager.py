"""Element-id bit layout and key mapping.

TPU-first redesign of the reference's id scheme (reference: titan-core
graphdb/idmanagement/IDManager.java:428-555). The reference packs ids as
``[count | partition | variable-length type suffix]``; we keep the same field
ORDER (count in the MSBs, partition in the middle, type in the LSBs) but make
the type field a FIXED 4-bit code. Rationale: fixed-width fields decode with
one mask/shift, which vectorizes over numpy/jnp arrays — the OLAP snapshot
builder and the TPU kernels strip type/partition bits on-device; a
variable-length suffix would force host-side scalar loops.

Layout of a 63-bit element id (bit 63 kept zero — ids are non-negative):

    [ count : 59-P bits | partition : P bits | type : 4 bits ]

P = log2(cluster.max-partitions), fixed at cluster creation.

Key mapping for key-ordered stores moves the partition field to the MSBs so a
partition occupies one contiguous key range (reference: IDManager.getKey
IDManager.java:467-493):

    key = [ partition : P bits | count : 59-P bits | type : 4 bits ]

Partitioned ("vertex-cut") vertices spread one logical vertex over ALL
partitions; each copy's id substitutes a different partition value and the
canonical representative lives at partition ``hash(count) % num_partitions``
(reference: IDManager.getPartitionedVertexRepresentatives IDManager.java:547-555).

Relation (edge/property) ids live in their own unpartitioned counter space.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from titan_tpu_torch.errors import InvalidIDError

TYPE_BITS = 4
TYPE_MASK = (1 << TYPE_BITS) - 1
TOTAL_BITS = 63  # keep sign bit clear


class IDType(enum.IntEnum):
    """4-bit element type code (LSBs of every element id)."""
    NORMAL_VERTEX = 0
    PARTITIONED_VERTEX = 1
    UNMODIFIABLE_VERTEX = 2
    INVISIBLE_VERTEX = 3
    USER_PROPERTY_KEY = 4
    SYSTEM_PROPERTY_KEY = 5
    USER_EDGE_LABEL = 6
    SYSTEM_EDGE_LABEL = 7
    VERTEX_LABEL = 8
    GENERIC_SCHEMA = 9

    @property
    def is_user_vertex(self) -> bool:
        return self in (IDType.NORMAL_VERTEX, IDType.PARTITIONED_VERTEX,
                        IDType.UNMODIFIABLE_VERTEX)

    @property
    def is_schema(self) -> bool:
        return self >= IDType.USER_PROPERTY_KEY

    @property
    def is_relation_type(self) -> bool:
        return self in (IDType.USER_PROPERTY_KEY, IDType.SYSTEM_PROPERTY_KEY,
                        IDType.USER_EDGE_LABEL, IDType.SYSTEM_EDGE_LABEL)

    @property
    def is_property_key(self) -> bool:
        return self in (IDType.USER_PROPERTY_KEY, IDType.SYSTEM_PROPERTY_KEY)

    @property
    def is_edge_label(self) -> bool:
        return self in (IDType.USER_EDGE_LABEL, IDType.SYSTEM_EDGE_LABEL)

    @property
    def is_system(self) -> bool:
        return self in (IDType.SYSTEM_PROPERTY_KEY, IDType.SYSTEM_EDGE_LABEL,
                        IDType.INVISIBLE_VERTEX)


SCHEMA_PARTITION = 0


@dataclass(frozen=True)
class IDManager:
    """Stateless id packing/unpacking for a fixed partition-bit width."""

    partition_bits: int

    def __post_init__(self):
        if not (0 <= self.partition_bits <= 16):
            raise InvalidIDError(f"partition_bits out of range: {self.partition_bits}")

    # -- derived constants --------------------------------------------------

    @property
    def num_partitions(self) -> int:
        return 1 << self.partition_bits

    @property
    def partition_mask(self) -> int:
        return (1 << self.partition_bits) - 1

    @property
    def count_bits(self) -> int:
        return TOTAL_BITS - TYPE_BITS - self.partition_bits

    @property
    def max_count(self) -> int:
        return (1 << self.count_bits) - 1

    @property
    def max_relation_count(self) -> int:
        return (1 << TOTAL_BITS) - 1

    # -- packing ------------------------------------------------------------

    def make_id(self, idtype: IDType, count: int, partition: int = 0) -> int:
        if not (0 < count <= self.max_count):
            raise InvalidIDError(f"count out of range: {count}")
        if not (0 <= partition < self.num_partitions):
            raise InvalidIDError(f"partition out of range: {partition}")
        if idtype.is_schema and partition != SCHEMA_PARTITION:
            raise InvalidIDError("schema ids live in partition 0")
        return (count << (TYPE_BITS + self.partition_bits)) | \
               (partition << TYPE_BITS) | int(idtype)

    def vertex_id(self, count: int, partition: int,
                  idtype: IDType = IDType.NORMAL_VERTEX) -> int:
        if not idtype.is_user_vertex:
            raise InvalidIDError(f"not a user vertex type: {idtype}")
        return self.make_id(idtype, count, partition)

    def schema_id(self, idtype: IDType, count: int) -> int:
        if not idtype.is_schema:
            raise InvalidIDError(f"not a schema type: {idtype}")
        return self.make_id(idtype, count, SCHEMA_PARTITION)

    def relation_id(self, count: int) -> int:
        """Relation ids are a bare counter (no partition/type fields); they
        never appear as row keys."""
        if not (0 < count <= self.max_relation_count):
            raise InvalidIDError(f"relation count out of range: {count}")
        return count

    # -- unpacking ----------------------------------------------------------

    def id_type(self, eid: int) -> IDType:
        try:
            return IDType(eid & TYPE_MASK)
        except ValueError:
            raise InvalidIDError(f"unknown type code in id {eid}")

    def partition(self, eid: int) -> int:
        return (eid >> TYPE_BITS) & self.partition_mask

    def count(self, eid: int) -> int:
        return eid >> (TYPE_BITS + self.partition_bits)

    def is_user_vertex_id(self, eid: int) -> bool:
        return eid > 0 and (eid & TYPE_MASK) <= int(IDType.UNMODIFIABLE_VERTEX)

    def is_schema_id(self, eid: int) -> bool:
        return eid > 0 and (eid & TYPE_MASK) >= int(IDType.USER_PROPERTY_KEY)

    def is_partitioned_vertex(self, eid: int) -> bool:
        return (eid & TYPE_MASK) == int(IDType.PARTITIONED_VERTEX)

    # -- key mapping (partition bits → MSBs) --------------------------------

    def key_of(self, eid: int) -> int:
        """Element id → 63-bit key integer with partition in the MSBs, so each
        partition is one contiguous key range in a key-ordered store."""
        t = eid & TYPE_MASK
        p = self.partition(eid)
        c = self.count(eid)
        return (p << (TOTAL_BITS - self.partition_bits)) | (c << TYPE_BITS) | t

    def id_of_key(self, key: int) -> int:
        p = key >> (TOTAL_BITS - self.partition_bits)
        c = (key >> TYPE_BITS) & ((1 << self.count_bits) - 1)
        t = key & TYPE_MASK
        return (c << (TYPE_BITS + self.partition_bits)) | (p << TYPE_BITS) | t

    def key_bytes(self, eid: int) -> bytes:
        return self.key_of(eid).to_bytes(8, "big")

    def id_of_key_bytes(self, key: bytes) -> int:
        return self.id_of_key(int.from_bytes(key, "big"))

    def partition_key_range(self, partition: int) -> tuple[bytes, bytes]:
        """[start, end) key range holding every element of a partition."""
        shift = TOTAL_BITS - self.partition_bits
        start = partition << shift
        end = (partition + 1) << shift
        return start.to_bytes(8, "big"), end.to_bytes(8, "big")

    # -- partitioned (vertex-cut) vertices ----------------------------------

    def canonical_partition(self, count: int) -> int:
        # cheap splittable hash so canonical copies spread over partitions
        h = (count * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
        return (h >> 40) & self.partition_mask

    def partitioned_vertex_id(self, count: int, partition: int) -> int:
        return self.make_id(IDType.PARTITIONED_VERTEX, count, partition)

    def canonical_vertex_id(self, eid: int) -> int:
        """Canonical representative of a partitioned vertex (identity for
        ordinary vertices)."""
        if not self.is_partitioned_vertex(eid):
            return eid
        c = self.count(eid)
        return self.partitioned_vertex_id(c, self.canonical_partition(c))

    def partitioned_vertex_representatives(self, eid: int) -> list[int]:
        if not self.is_partitioned_vertex(eid):
            raise InvalidIDError(f"not a partitioned vertex: {eid}")
        c = self.count(eid)
        return [self.partitioned_vertex_id(c, p) for p in range(self.num_partitions)]

    def canonicalize_np(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized canonical_vertex_id: partitioned-vertex ids are mapped
        to their canonical representative, everything else passes through
        (the OLAP snapshot builder merges vertex-cut rows with this)."""
        ids = np.asarray(ids, dtype=np.int64)
        is_part = (ids & TYPE_MASK) == int(IDType.PARTITIONED_VERTEX)
        if not is_part.any():
            return ids
        counts = ids >> (TYPE_BITS + self.partition_bits)
        h = counts.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        canon_p = ((h >> np.uint64(40)).astype(np.int64)) & self.partition_mask
        canon = ((counts << (TYPE_BITS + self.partition_bits))
                 | (canon_p << TYPE_BITS) | int(IDType.PARTITIONED_VERTEX))
        return np.where(is_part, canon, ids)

    # -- vectorized unpacking (device/bulk paths) ---------------------------

    def partitions_np(self, ids: np.ndarray) -> np.ndarray:
        return (ids >> TYPE_BITS) & self.partition_mask

    def counts_np(self, ids: np.ndarray) -> np.ndarray:
        return ids >> (TYPE_BITS + self.partition_bits)

    def types_np(self, ids: np.ndarray) -> np.ndarray:
        return ids & TYPE_MASK

    def keys_np(self, ids: np.ndarray) -> np.ndarray:
        t = ids & TYPE_MASK
        p = (ids >> TYPE_BITS) & self.partition_mask
        c = ids >> (TYPE_BITS + self.partition_bits)
        return (p << (TOTAL_BITS - self.partition_bits)) | (c << TYPE_BITS) | t
