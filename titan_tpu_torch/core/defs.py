"""Basic graph-model enums shared by the codec, schema and query layers.

(reference: titan-core core/Cardinality.java, core/Multiplicity.java,
TinkerPop Direction; RelationCategory in graphdb/internal/)
"""

from __future__ import annotations

import enum


class Direction(enum.IntEnum):
    OUT = 0
    IN = 1
    BOTH = 2

    def reverse(self) -> "Direction":
        if self is Direction.OUT:
            return Direction.IN
        if self is Direction.IN:
            return Direction.OUT
        return Direction.BOTH


class Cardinality(enum.Enum):
    """Property cardinality per vertex (reference: core/Cardinality.java)."""
    SINGLE = "single"
    LIST = "list"
    SET = "set"


class Multiplicity(enum.Enum):
    """Edge multiplicity constraint (reference: core/Multiplicity.java)."""
    MULTI = "multi"
    SIMPLE = "simple"        # at most one edge between a vertex pair
    MANY2ONE = "many2one"    # each vertex: at most one OUT edge (e.g. "mother")
    ONE2MANY = "one2many"    # each vertex: at most one IN edge (e.g. "winnerOf")
    ONE2ONE = "one2one"

    def unique(self, direction: Direction) -> bool:
        """Is there at most one edge in ``direction`` per vertex?
        (reference: Multiplicity.isUnique)"""
        if self is Multiplicity.MANY2ONE:
            return direction is Direction.OUT
        if self is Multiplicity.ONE2MANY:
            return direction is Direction.IN
        if self is Multiplicity.ONE2ONE:
            return direction in (Direction.OUT, Direction.IN)
        return False

    @staticmethod
    def from_cardinality(c: Cardinality) -> "Multiplicity":
        # properties are modeled as relations; SINGLE → MANY2ONE etc.
        return {Cardinality.SINGLE: Multiplicity.MANY2ONE,
                Cardinality.LIST: Multiplicity.MULTI,
                Cardinality.SET: Multiplicity.SIMPLE}[c]


class RelationCategory(enum.Enum):
    EDGE = "edge"
    PROPERTY = "property"
    RELATION = "relation"   # either


class ElementLifecycle(enum.IntEnum):
    """(reference: graphdb/internal/ElementLifeCycle.java)"""
    NEW = 1
    LOADED = 2
    MODIFIED = 3
    REMOVED = 4


class SchemaStatus(enum.Enum):
    """Index/schema lifecycle states (reference: core/schema/SchemaStatus.java)."""
    INSTALLED = "installed"
    REGISTERED = "registered"
    ENABLED = "enabled"
    DISABLED = "disabled"


class SchemaAction(enum.Enum):
    """Index lifecycle transitions (reference: core/schema/SchemaAction.java:12-50
    — REGISTER_INDEX/REINDEX/ENABLE_INDEX/DISABLE_INDEX/REMOVE_INDEX with
    applicable source states)."""
    REGISTER_INDEX = "register"
    REINDEX = "reindex"
    ENABLE_INDEX = "enable"
    DISABLE_INDEX = "disable"
    REMOVE_INDEX = "remove"

    def applicable_from(self, status: "SchemaStatus") -> bool:
        return status in {
            SchemaAction.REGISTER_INDEX: (SchemaStatus.INSTALLED,),
            SchemaAction.REINDEX: (SchemaStatus.REGISTERED,
                                   SchemaStatus.ENABLED),
            SchemaAction.ENABLE_INDEX: (SchemaStatus.REGISTERED,),
            SchemaAction.DISABLE_INDEX: (SchemaStatus.REGISTERED,
                                         SchemaStatus.INSTALLED,
                                         SchemaStatus.ENABLED),
            SchemaAction.REMOVE_INDEX: (SchemaStatus.DISABLED,),
        }[self]
