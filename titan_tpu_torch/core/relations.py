"""Internal relation model shared by the transaction and commit path.

(reference: titan-core graphdb/relations/ — StandardEdge, StandardVertexProperty,
CacheEdge/CacheVertexProperty and graphdb/internal/InternalRelation: a
relation is an edge OR a vertex property; edges span (out, in) vertices,
properties attach to one vertex. The codec (codec/edges.py) is deterministic,
so deletions re-serialize the relation instead of caching raw entry bytes.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from titan_tpu_torch.core.defs import Direction, ElementLifecycle, RelationCategory


@dataclass
class InternalRelation:
    relation_id: int
    type_id: int
    category: RelationCategory
    out_vertex_id: int                  # property: owning vertex
    in_vertex_id: Optional[int] = None  # edges only
    value: Any = None                   # properties only
    properties: dict = field(default_factory=dict)  # meta-properties / edge props
    lifecycle: ElementLifecycle = ElementLifecycle.NEW

    @property
    def is_edge(self) -> bool:
        return self.category is RelationCategory.EDGE

    @property
    def is_property(self) -> bool:
        return self.category is RelationCategory.PROPERTY

    def vertex_ids(self) -> tuple:
        if self.is_edge:
            return (self.out_vertex_id, self.in_vertex_id)
        return (self.out_vertex_id,)

    def direction_of(self, vertex_id: int) -> Direction:
        if not self.is_edge:
            return Direction.OUT
        if vertex_id == self.out_vertex_id:
            return Direction.OUT
        if vertex_id == self.in_vertex_id:
            return Direction.IN
        raise ValueError(f"vertex {vertex_id} not incident to relation "
                         f"{self.relation_id}")

    def other_vertex_id(self, vertex_id: int) -> int:
        if vertex_id == self.out_vertex_id:
            return self.in_vertex_id
        return self.out_vertex_id
