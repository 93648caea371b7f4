"""Built-in system schema types with fixed ids.

(reference: titan-core graphdb/types/system/BaseKey.java, BaseLabel.java,
ImplicitKey.java — system property keys/labels with hardcoded ids that the
engine needs before any user schema exists: the vertex-existence marker, the
schema-name lookup key, the type-definition payload and the vertex-label
edge.)
"""

from __future__ import annotations

from titan_tpu_torch.core.defs import Cardinality, Multiplicity
from titan_tpu_torch.ids import IDManager, IDType

# fixed counts in the system id spaces — part of the stored format
VERTEX_EXISTS_COUNT = 1
SCHEMA_NAME_COUNT = 2
TYPE_DEFINITION_COUNT = 3
VERTEX_LABEL_EDGE_COUNT = 1

_SYS_KEYS = {
    VERTEX_EXISTS_COUNT: ("~exists", bool, Cardinality.SINGLE),
    SCHEMA_NAME_COUNT: ("~schemaname", str, Cardinality.SINGLE),
    TYPE_DEFINITION_COUNT: ("~typedefinition", dict, Cardinality.SINGLE),
}

_SYS_LABELS = {
    VERTEX_LABEL_EDGE_COUNT: ("~vertexlabel", Multiplicity.MANY2ONE),
}


class SystemTypes:
    """Resolves the fixed system ids for a given IDManager width."""

    def __init__(self, idm: IDManager):
        self.idm = idm
        self.vertex_exists = idm.schema_id(IDType.SYSTEM_PROPERTY_KEY,
                                           VERTEX_EXISTS_COUNT)
        self.schema_name = idm.schema_id(IDType.SYSTEM_PROPERTY_KEY,
                                         SCHEMA_NAME_COUNT)
        self.type_definition = idm.schema_id(IDType.SYSTEM_PROPERTY_KEY,
                                             TYPE_DEFINITION_COUNT)
        self.vertex_label_edge = idm.schema_id(IDType.SYSTEM_EDGE_LABEL,
                                               VERTEX_LABEL_EDGE_COUNT)
        self._keys = {idm.schema_id(IDType.SYSTEM_PROPERTY_KEY, c): v
                      for c, v in _SYS_KEYS.items()}
        self._labels = {idm.schema_id(IDType.SYSTEM_EDGE_LABEL, c): v
                        for c, v in _SYS_LABELS.items()}

    def is_system(self, type_id: int) -> bool:
        return type_id in self._keys or type_id in self._labels

    def key_info(self, key_id: int):
        return self._keys.get(key_id)

    def label_info(self, label_id: int):
        return self._labels.get(label_id)

    def name_of(self, type_id: int) -> str | None:
        if type_id in self._keys:
            return self._keys[type_id][0]
        if type_id in self._labels:
            return self._labels[type_id][0]
        return None
