"""Cluster-global configuration + instance registry inside the backend.

(reference: titan-core diskstorage/configuration/backend/KCVSConfiguration.java
over the ``system_properties`` store, wired at Backend.java:273-298: GLOBAL
options live in the database itself; every instance merges them with its
local file at open; GLOBAL_OFFLINE changes require all instances down. Also
the instance registry StandardTitanGraph.java:142-148 — duplicate instance
ids refuse to start; ManagementSystem can force-evict dead instances.)
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterable

from titan_tpu_torch.codec.attributes import Serializer
from titan_tpu_torch.config.configuration import WriteConfiguration
from titan_tpu_torch.errors import TitanError
from titan_tpu_torch.storage.api import Entry, KeySliceQuery, SliceQuery

_CONFIG_ROW = b"\x00configuration"
_INSTANCE_ROW = b"\x00instances"


class KCVSConfiguration(WriteConfiguration):
    """WriteConfiguration view over one row of the config store."""

    def __init__(self, store, manager, serializer: Serializer | None = None,
                 row: bytes = _CONFIG_ROW):
        self._store = store
        self._manager = manager
        self._ser = serializer or Serializer()
        self._row = row
        self._lock = threading.RLock()

    def _txh(self):
        return self._manager.begin_transaction()

    def get(self, key: str) -> Any:
        txh = self._txh()
        try:
            col = key.encode("utf-8")
            entries = self._store.get_slice(
                KeySliceQuery(self._row, SliceQuery(col, col + b"\x00")), txh)
        finally:
            txh.commit()
        if not entries or entries[0].column != col:
            return None
        return self._ser.value_from_bytes(entries[0].value)

    def keys(self, prefix: str = "") -> Iterable[str]:
        txh = self._txh()
        try:
            entries = self._store.get_slice(
                KeySliceQuery(self._row, SliceQuery()), txh)
        finally:
            txh.commit()
        out = []
        for e in entries:
            k = e.column.decode("utf-8", errors="replace")
            if k.startswith(prefix):
                out.append(k)
        return out

    def set(self, key: str, value: Any) -> None:
        txh = self._txh()
        try:
            self._store.mutate(self._row,
                               [Entry(key.encode("utf-8"),
                                      self._ser.value_bytes(value))], [], txh)
            txh.commit()
        except BaseException:
            txh.rollback()
            raise

    def remove(self, key: str) -> None:
        txh = self._txh()
        try:
            self._store.mutate(self._row, [], [key.encode("utf-8")], txh)
            txh.commit()
        except BaseException:
            txh.rollback()
            raise


class InstanceRegistry:
    """Running-instance registry in the config store."""

    def __init__(self, store, manager):
        self._store = store
        self._manager = manager

    def register(self, instance_id: str) -> None:
        txh = self._manager.begin_transaction()
        col = instance_id.encode("utf-8")
        try:
            existing = self._store.get_slice(
                KeySliceQuery(_INSTANCE_ROW, SliceQuery(col, col + b"\x00")),
                txh)
        finally:
            txh.commit()
        if existing and existing[0].column == col:
            raise TitanError(
                f"instance id {instance_id!r} is already registered — another "
                f"instance with this id is running (or died uncleanly; evict "
                f"it via the management system)")
        txh = self._manager.begin_transaction()
        try:
            self._store.mutate(_INSTANCE_ROW,
                               [Entry(col, int(time.time() * 1e6)
                                      .to_bytes(8, "big"))], [], txh)
            txh.commit()
        except BaseException:
            txh.rollback()
            raise

    def deregister(self, instance_id: str) -> None:
        txh = self._manager.begin_transaction()
        try:
            self._store.mutate(_INSTANCE_ROW, [],
                               [instance_id.encode("utf-8")], txh)
            txh.commit()
        except BaseException:
            txh.rollback()

    def instances(self) -> list[str]:
        txh = self._manager.begin_transaction()
        try:
            entries = self._store.get_slice(
                KeySliceQuery(_INSTANCE_ROW, SliceQuery()), txh)
        finally:
            txh.commit()
        return [e.column.decode("utf-8") for e in entries]

    force_evict = deregister  # (reference: ManagementSystem.forceCloseInstance)
