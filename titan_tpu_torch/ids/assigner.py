"""Vertex/relation/schema id assignment.

(reference: titan-core graphdb/database/idassigner/VertexIDAssigner.java:486 —
routes each new element to an id pool: vertices to a per-partition pool chosen
by the placement strategy (retrying exhausted partitions, :44
MAX_PARTITION_RENEW_ATTEMPTS), relations to a flat pool, schema elements to
the partition-0 schema namespace.)
"""

from __future__ import annotations

import threading

from titan_tpu_torch.errors import IDPoolExhaustedError
from titan_tpu_torch.ids.authority import IDAuthority
from titan_tpu_torch.ids.idmanager import IDManager, IDType
from titan_tpu_torch.ids.placement import IDPlacementStrategy, SimpleBulkPlacement
from titan_tpu_torch.ids.pool import StandardIDPool

MAX_PARTITION_ATTEMPTS = 10


class IDAssigner:
    def __init__(self, idm: IDManager, authority: IDAuthority,
                 block_size: int = 10_000, renew_percentage: float = 0.3,
                 placement: IDPlacementStrategy | None = None):
        self._idm = idm
        self._authority = authority
        self._block_size = block_size
        self._renew = renew_percentage
        self.placement = placement or SimpleBulkPlacement(idm.num_partitions)
        self._vertex_pools: dict[int, StandardIDPool] = {}
        self._relation_pool = StandardIDPool(
            authority, b"relation", block_size * 4, idm.max_relation_count,
            renew_percentage)
        self._schema_pool = StandardIDPool(
            authority, b"schema", 64, idm.max_count, renew_percentage)
        self._lock = threading.Lock()

    def _vertex_pool(self, partition: int) -> StandardIDPool:
        pool = self._vertex_pools.get(partition)
        if pool is None:
            with self._lock:
                pool = self._vertex_pools.get(partition)
                if pool is None:
                    pool = StandardIDPool(
                        self._authority, b"partition%d" % partition,
                        self._block_size, self._idm.max_count, self._renew)
                    self._vertex_pools[partition] = pool
        return pool

    def next_vertex_id(self, vertex=None,
                       idtype: IDType = IDType.NORMAL_VERTEX) -> int:
        for _ in range(MAX_PARTITION_ATTEMPTS):
            partition = self.placement.partition_for(vertex)
            try:
                count = self._vertex_pool(partition).next_id()
            except IDPoolExhaustedError:
                self.placement.exhausted(partition)
                continue
            return self._idm.vertex_id(count, partition, idtype)
        raise IDPoolExhaustedError("no partition with available ids")

    def next_relation_id(self) -> int:
        return self._idm.relation_id(self._relation_pool.next_id())

    def next_schema_id(self, idtype: IDType) -> int:
        return self._idm.schema_id(idtype, self._schema_pool.next_id())

    def close(self):
        for p in self._vertex_pools.values():
            p.close()
        self._relation_pool.close()
        self._schema_pool.close()
