"""Partition placement strategies.

(reference: titan-core graphdb/database/idassigner/placement/
SimpleBulkPlacementStrategy.java — picks a random partition and reuses it for
a batch of vertices so co-created vertices co-locate; PropertyPlacementStrategy
hashes a designated property so equal values co-locate.)
"""

from __future__ import annotations

import random
import threading
from typing import Optional


class IDPlacementStrategy:
    def partition_for(self, vertex) -> int:
        raise NotImplementedError

    def exhausted(self, partition: int) -> None:
        """Called when a partition's id space ran out; avoid it from now on."""


class SimpleBulkPlacement(IDPlacementStrategy):
    def __init__(self, num_partitions: int, batch_size: int = 10_000,
                 seed: Optional[int] = None):
        self._n = num_partitions
        self._batch = batch_size
        self._rng = random.Random(seed)
        self._exhausted: set[int] = set()
        self._lock = threading.Lock()
        self._current = self._pick()
        self._used = 0

    def _pick(self) -> int:
        live = [p for p in range(self._n) if p not in self._exhausted]
        if not live:
            raise RuntimeError("all partitions exhausted")
        return self._rng.choice(live)

    def partition_for(self, vertex) -> int:
        with self._lock:
            self._used += 1
            if self._used >= self._batch or self._current in self._exhausted:
                self._current = self._pick()
                self._used = 0
            return self._current

    def exhausted(self, partition: int) -> None:
        with self._lock:
            self._exhausted.add(partition)
            if self._current == partition:
                self._current = self._pick()
                self._used = 0


class PropertyPlacement(IDPlacementStrategy):
    """Co-locate vertices by the hash of a property value
    (reference: placement/PropertyPlacementStrategy.java)."""

    def __init__(self, num_partitions: int, key_name: str,
                 fallback: Optional[IDPlacementStrategy] = None):
        self._n = num_partitions
        self._key = key_name
        self._fallback = fallback or SimpleBulkPlacement(num_partitions)

    def partition_for(self, vertex) -> int:
        value = None
        getter = getattr(vertex, "pending_property", None)
        if getter is not None:
            value = getter(self._key)
        if value is None:
            return self._fallback.partition_for(vertex)
        h = hash((self._key, value)) & 0x7FFFFFFF
        return h % self._n

    def exhausted(self, partition: int) -> None:
        self._fallback.exhausted(partition)
