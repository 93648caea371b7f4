"""Management system: schema DDL surface.

(reference: titan-core graphdb/database/management/ManagementSystem.java:1304
— schema creation/inspection; index lifecycle (SchemaAction) and instance
management land with the index subsystem.)
"""

from __future__ import annotations

from typing import Optional

from titan_tpu_torch.core.defs import Cardinality, Multiplicity
from titan_tpu_torch.core.schema import EdgeLabel, PropertyKey, VertexLabel
from titan_tpu_torch.errors import TitanError


class ManagementSystem:
    def __init__(self, graph):
        self.graph = graph
        self.schema = graph.schema
        self._open = True
        # keys created through THIS management session: an index over only
        # fresh keys can be ENABLED immediately, one over pre-existing keys
        # starts INSTALLED and must go through REGISTER/REINDEX/ENABLE
        # (reference: ManagementSystem.buildIndex + SchemaStatus rules)
        self._created_keys: set[int] = set()

    # -- makers --------------------------------------------------------------

    def make_property_key(self, name: str, dtype: type = str,
                          cardinality: Cardinality = Cardinality.SINGLE
                          ) -> PropertyKey:
        pk = self.schema.make_property_key(name, dtype, cardinality)
        self._created_keys.add(pk.id)
        return pk

    def make_edge_label(self, name: str,
                        multiplicity: Multiplicity = Multiplicity.MULTI,
                        unidirected: bool = False,
                        sort_key: tuple = ()) -> EdgeLabel:
        return self.schema.make_edge_label(name, multiplicity, unidirected,
                                           sort_key)

    def make_vertex_label(self, name: str, partitioned: bool = False,
                          static: bool = False) -> VertexLabel:
        return self.schema.make_vertex_label(name, partitioned, static)

    # -- TTL (reference: TitanManagement.setTTL/getTTL — per-type cell TTL
    # honored by stores with features.cell_ttl) ------------------------------

    def set_ttl(self, schema_type, ttl_seconds: float):
        """TTL for relations of an edge label / property key, or for whole
        vertices of a STATIC vertex label (the reference's constraint:
        vertex TTL requires a static label, since later modifications would
        outlive the original cells)."""
        import dataclasses

        from titan_tpu_torch.core.schema import (EdgeLabel, PropertyKey,
                                           SchemaType, VertexLabel)
        st = schema_type if isinstance(schema_type, SchemaType) \
            else self.schema.get_by_name(schema_type)
        if st is None or not isinstance(st, (EdgeLabel, PropertyKey,
                                             VertexLabel)):
            raise TitanError(f"cannot set TTL on {schema_type!r}")
        if isinstance(st, VertexLabel) and not st.static and ttl_seconds > 0:
            raise TitanError(
                f"vertex label {st.name!r} must be static to carry a TTL")
        if not self.graph.backend.features.cell_ttl and ttl_seconds > 0:
            raise TitanError(
                "storage backend does not support cell TTL")
        return self.schema.update_type(
            dataclasses.replace(st, ttl=float(ttl_seconds)))

    def get_ttl(self, schema_type) -> float:
        from titan_tpu_torch.core.schema import SchemaType
        st = schema_type if isinstance(schema_type, SchemaType) \
            else self.schema.get_by_name(schema_type)
        return getattr(st, "ttl", 0.0) if st is not None else 0.0

    # -- inspection ----------------------------------------------------------

    def get_property_key(self, name: str) -> Optional[PropertyKey]:
        st = self.schema.get_by_name(name)
        return st if isinstance(st, PropertyKey) else None

    def get_edge_label(self, name: str) -> Optional[EdgeLabel]:
        st = self.schema.get_by_name(name)
        return st if isinstance(st, EdgeLabel) else None

    def get_vertex_label(self, name: str) -> Optional[VertexLabel]:
        st = self.schema.get_by_name(name)
        return st if isinstance(st, VertexLabel) else None

    def contains_relation_type(self, name: str) -> bool:
        st = self.schema.get_by_name(name)
        return isinstance(st, (PropertyKey, EdgeLabel))

    def contains_vertex_label(self, name: str) -> bool:
        return isinstance(self.schema.get_by_name(name), VertexLabel)

    # -- consistency (reference: TitanManagement.setConsistency) -------------

    def set_consistency(self, schema_type, modifier: str):
        """``modifier``: 'none' or 'lock' — LOCK types acquire consistent-key
        locks on their unique columns at commit."""
        if modifier not in ("none", "lock"):
            raise ValueError("consistency must be 'none' or 'lock'")
        import dataclasses
        updated = dataclasses.replace(schema_type, consistency=modifier)
        return self.schema.update_type(updated)

    # -- instances (reference: ManagementSystem instance surface) ------------

    def open_instances(self) -> list:
        return self.graph.backend.instance_registry.instances()

    # reference API name
    get_open_instances = open_instances

    def force_close_instance(self, instance_id: str) -> None:
        """Evict a dead instance's registration (reference:
        ManagementSystem.forceCloseInstance — for instances that crashed
        without deregistering)."""
        if instance_id == self.graph.instance_id:
            raise TitanError(
                "cannot force-close the current instance; close the graph")
        self.graph.backend.instance_registry.force_evict(instance_id)

    # -- graph indexes (reference: TitanManagement.buildIndex) ---------------

    def build_index(self, name: str, element: str = "vertex") -> "IndexBuilder":
        return IndexBuilder(self, name, element)

    def get_graph_index(self, name: str):
        from titan_tpu_torch.core.schema import IndexDefinition
        st = self.schema.get_by_name(name)
        return st if isinstance(st, IndexDefinition) else None

    def get_graph_indexes(self, element: Optional[str] = None) -> list:
        return self.schema.indexes(element)

    def contains_graph_index(self, name: str) -> bool:
        return self.get_graph_index(name) is not None

    def update_index(self, index, action, num_threads: int = 2):
        """Apply a lifecycle transition (reference:
        ManagementSystem.updateIndex + SchemaAction semantics — REGISTER
        broadcasts and awaits acks; single-coordinator here, so transitions
        apply immediately; REINDEX/REMOVE run the scan jobs inline)."""
        from titan_tpu_torch.core.defs import SchemaAction, SchemaStatus
        from titan_tpu_torch.errors import TitanError
        if isinstance(action, str):
            action = SchemaAction(action)
        idx = self.get_graph_index(index if isinstance(index, str)
                                   else index.name)
        if idx is None:
            raise TitanError(f"unknown index: {index!r}")
        if not action.applicable_from(idx.status):
            raise TitanError(
                f"cannot {action.value} index {idx.name!r} from status "
                f"{idx.status.value}")

        from titan_tpu_torch.indexing import jobs as index_jobs
        if action is SchemaAction.REGISTER_INDEX:
            return self._set_index_status(idx, SchemaStatus.REGISTERED)
        if action is SchemaAction.ENABLE_INDEX:
            return self._set_index_status(idx, SchemaStatus.ENABLED)
        if action is SchemaAction.DISABLE_INDEX:
            return self._set_index_status(idx, SchemaStatus.DISABLED)
        if action is SchemaAction.REINDEX:
            index_jobs.reindex(self.graph, idx, num_threads)
            return self._set_index_status(idx, SchemaStatus.ENABLED)
        if action is SchemaAction.REMOVE_INDEX:
            index_jobs.remove_index_data(self.graph, idx, num_threads)
            return idx

    def _set_index_status(self, idx, status):
        import dataclasses
        updated = dataclasses.replace(idx, status=status)
        return self.schema.update_type(updated)

    def await_graph_index_status(self, name: str, status=None,
                                 timeout_s: float = 60.0):
        """Block until the index reaches ``status`` (reference:
        GraphIndexStatusWatcher). Transitions are synchronous here, so this
        returns immediately — kept for API parity with the reference."""
        idx = self.get_graph_index(name)
        if idx is None:
            raise ValueError(f"unknown index {name!r}")
        return idx

    # -- cluster-global options ----------------------------------------------

    def set_global_option(self, option, value, *umbrella) -> None:
        from titan_tpu_torch.config import ModifiableConfiguration, Restriction, defaults
        mod = ModifiableConfiguration(defaults.ROOT,
                                      self.graph.backend.global_config_store,
                                      Restriction.GLOBAL)
        mod.set(option, value, *umbrella)

    def get_global_option(self, option, *umbrella):
        from titan_tpu_torch.config import Configuration, defaults
        cfg = Configuration(defaults.ROOT,
                            self.graph.backend.global_config_store)
        return cfg.get(option, *umbrella)

    def commit(self):
        self._open = False

    def rollback(self):
        self._open = False


class IndexBuilder:
    """Fluent index construction (reference: TitanManagement.IndexBuilder,
    ManagementSystem.buildIndex)."""

    def __init__(self, mgmt: ManagementSystem, name: str, element: str):
        if element not in ("vertex", "edge"):
            raise ValueError("element must be 'vertex' or 'edge'")
        self.mgmt = mgmt
        self.name = name
        self.element = element
        self._keys: list[tuple[int, str]] = []      # (key id, mapping param)
        self._unique = False
        self._index_only = 0

    def add_key(self, key, *params) -> "IndexBuilder":
        pk = key if not isinstance(key, str) else \
            self.mgmt.schema.get_by_name(key)
        if pk is None or not pk.is_property_key:
            raise ValueError(f"not a property key: {key!r}")
        self._keys.append((pk.id, params[0] if params else "DEFAULT"))
        return self

    def unique(self) -> "IndexBuilder":
        self._unique = True
        return self

    def index_only(self, label) -> "IndexBuilder":
        st = label if not isinstance(label, str) else \
            self.mgmt.schema.get_by_name(label)
        if st is None:
            raise ValueError(f"unknown schema type {label!r}")
        self._index_only = st.id
        return self

    def _initial_status(self):
        from titan_tpu_torch.core.defs import SchemaStatus
        fresh = all(kid in self.mgmt._created_keys
                    for kid, _ in self._keys)
        return SchemaStatus.ENABLED if fresh else SchemaStatus.INSTALLED

    def build_composite_index(self):
        if not self._keys:
            raise ValueError("an index needs at least one key")
        return self.mgmt.schema.make_index(
            self.name, self.element, composite=True,
            key_ids=tuple(k for k, _ in self._keys),
            key_params=tuple(p for _, p in self._keys),
            unique=self._unique, index_only=self._index_only,
            status=self._initial_status())

    def build_mixed_index(self, backing: str):
        if not self._keys:
            raise ValueError("an index needs at least one key")
        if self._unique:
            raise ValueError("mixed indexes cannot be unique")
        idx = self.mgmt.schema.make_index(
            self.name, self.element, composite=False,
            key_ids=tuple(k for k, _ in self._keys),
            key_params=tuple(p for _, p in self._keys),
            backing=backing, index_only=self._index_only,
            status=self._initial_status())
        provider = self.mgmt.graph.index_provider(backing)
        if provider is not None:
            self.mgmt.graph.index_serializer.register_keys(provider, idx)
        return idx
