"""Public element objects: Vertex, Edge, VertexProperty.

(reference: titan-core core/TitanVertex.java, TitanEdge.java,
TitanVertexProperty.java + the internal implementations under
graphdb/vertices/ and graphdb/relations/. These are thin tx-bound handles:
all state lives in the transaction's caches and the store.)
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

from titan_tpu_torch.core.defs import Cardinality, Direction, RelationCategory
from titan_tpu_torch.core.relations import InternalRelation
from titan_tpu_torch.errors import InvalidElementError


_UNSET = object()


class Element:
    __slots__ = ("tx", "_id")

    def __init__(self, tx, eid: int):
        self.tx = tx
        self._id = eid

    @property
    def id(self) -> int:
        return self._id

    @property
    def graph(self):
        return self.tx.graph

    def __eq__(self, other):
        return isinstance(other, Element) and other._id == self._id

    def __hash__(self):
        return hash(self._id)


class Vertex(Element):
    __slots__ = ()

    # -- schema --------------------------------------------------------------

    def label(self) -> str:
        return self.tx.vertex_label_name(self._id)

    # -- properties ----------------------------------------------------------

    def property(self, key: str, value: Any = _UNSET) -> Any:
        """``v.property("k")`` reads; ``v.property("k", v)`` writes."""
        if value is _UNSET:
            props = list(self.tx.vertex_properties(self._id, [key]))
            return props[0] if props else None
        return self.tx.add_property(self, key, value)

    def value(self, key: str, default: Any = None) -> Any:
        props = list(self.tx.vertex_properties(self._id, [key]))
        if not props:
            return default
        return props[0].value

    def values(self, *keys: str) -> list:
        return [p.value for p in self.tx.vertex_properties(self._id,
                                                           list(keys) or None)]

    def properties(self, *keys: str) -> Iterator["VertexProperty"]:
        return self.tx.vertex_properties(self._id, list(keys) or None)

    # -- adjacency -----------------------------------------------------------

    def add_edge(self, label: str, in_vertex: "Vertex", **props) -> "Edge":
        return self.tx.add_edge(self, label, in_vertex, props)

    def edges(self, direction: Direction = Direction.BOTH,
              *labels: str) -> Iterator["Edge"]:
        return self.tx.vertex_edges(self._id, direction, list(labels) or None)

    def out_edges(self, *labels: str):
        return self.edges(Direction.OUT, *labels)

    def in_edges(self, *labels: str):
        return self.edges(Direction.IN, *labels)

    def vertices(self, direction: Direction = Direction.BOTH,
                 *labels: str) -> Iterator["Vertex"]:
        for e in self.edges(direction, *labels):
            yield e.other(self)

    def out(self, *labels: str):
        return self.vertices(Direction.OUT, *labels)

    def in_(self, *labels: str):
        return self.vertices(Direction.IN, *labels)

    def both(self, *labels: str):
        return self.vertices(Direction.BOTH, *labels)

    def query(self):
        from titan_tpu_torch.query.vertexquery import \
            VertexCentricQueryBuilder
        return VertexCentricQueryBuilder(self.tx, self._id)

    def degree(self, direction: Direction = Direction.BOTH, *labels) -> int:
        return sum(1 for _ in self.edges(direction, *labels))

    def remove(self) -> None:
        self.tx.remove_vertex(self)

    def __repr__(self):
        return f"v[{self._id}]"


class RelationElement(Element):
    """Base for edges and vertex properties (both are relations)."""
    __slots__ = ("rel",)

    def __init__(self, tx, rel: InternalRelation):
        super().__init__(tx, rel.relation_id)
        self.rel = rel

    def type_name(self) -> str:
        return self.tx.schema_name(self.rel.type_id)

    def property_map(self) -> dict:
        """Inline properties by key name: edge properties on an Edge,
        meta-properties on a VertexProperty."""
        return {self.tx.schema_name(kid): v
                for kid, v in self.rel.properties.items()}

    def remove(self) -> None:
        self.tx.remove_relation(self.rel)


class Edge(RelationElement):
    __slots__ = ()

    def label(self) -> str:
        return self.type_name()

    def out_vertex(self) -> Vertex:
        return self.tx.vertex_handle(self.rel.out_vertex_id)

    def in_vertex(self) -> Vertex:
        return self.tx.vertex_handle(self.rel.in_vertex_id)

    def other(self, v: Vertex) -> Vertex:
        return self.tx.vertex_handle(self.rel.other_vertex_id(v.id))

    def vertices(self):
        return (self.out_vertex(), self.in_vertex())

    def value(self, key: str, default: Any = None) -> Any:
        st = self.tx.schema.get_by_name(key)
        if st is None:
            return default
        return self.rel.properties.get(st.id, default)

    def values(self, *keys: str) -> list:
        return [self.value(k) for k in keys]

    def __repr__(self):
        return (f"e[{self._id}][{self.rel.out_vertex_id}-"
                f"{self.label()}->{self.rel.in_vertex_id}]")


class VertexProperty(RelationElement):
    __slots__ = ()

    def key(self) -> str:
        return self.type_name()

    @property
    def value(self) -> Any:
        return self.rel.value

    def meta(self, key: str, default: Any = None) -> Any:
        """Read a meta-property (reference: TitanVertexProperty.value(key));
        set via tx.add_meta_property."""
        st = self.tx.schema.get_by_name(key)
        if st is None:
            return default
        return self.rel.properties.get(st.id, default)

    def element(self) -> Vertex:
        return self.tx.vertex_handle(self.rel.out_vertex_id)

    def __repr__(self):
        return f"vp[{self.key()}->{self.value!r}]"
