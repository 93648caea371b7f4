"""The vertex-program contract of the engine (port of ``DenseProgram``,
``DenseMapReduce`` and the classic ``MapReduce`` stage with its emitters
and ``execute_map_reduce`` in ``titan_tpu/olap/api.py``). The dense
callbacks take and return torch tensors; a classic stage maps host
vertex views."""

from __future__ import annotations

import abc
from typing import Any, Sequence


class MapEmitter:
    """Collects (key, value) pairs from map() (reference:
    FulgoraMapEmitter)."""

    def __init__(self):
        self.pairs: list = []

    def emit(self, key, value) -> None:
        self.pairs.append((key, value))


class ReduceEmitter:
    """Collects (key, value) pairs from combine()/reduce() (reference:
    FulgoraReduceEmitter)."""

    def __init__(self):
        self.pairs: list = []

    def emit(self, key, value) -> None:
        self.pairs.append((key, value))


class MapReduce(abc.ABC):
    """Post-BSP aggregation stage (reference: TinkerPop MapReduce executed
    at FulgoraGraphComputer.java:192-246 — map over all vertices, optional
    per-worker combine, grouped reduce, result stored in Memory under
    ``memory_key``)."""

    memory_key: str = "mapreduce"

    @abc.abstractmethod
    def map(self, vertex, emitter: MapEmitter) -> None: ...

    def has_combine(self) -> bool:
        return type(self).combine is not MapReduce.combine

    def combine(self, key, values: list, emitter: ReduceEmitter) -> None:
        """Optional associative pre-reduce applied per worker chunk."""
        self.reduce(key, values, emitter)

    def has_reduce(self) -> bool:
        return type(self).reduce is not MapReduce.reduce

    def reduce(self, key, values: list, emitter: ReduceEmitter) -> None:
        """Default: pass map output through unchanged."""
        for v in values:
            emitter.emit(key, v)

    def finalize(self, results: dict):
        """Grouped {key: [values]} → the object stored in Memory
        (reference: MapReduce.generateFinalResult)."""
        return results


def execute_map_reduce(mr: MapReduce, vertices, chunk: int = 4096) -> Any:
    """Run one MapReduce over an iterable of vertex views: map → per-chunk
    combine → grouped reduce → finalize."""
    combined: dict = {}

    def absorb(pairs):
        if mr.has_combine():
            by_key: dict = {}
            for k, v in pairs:
                by_key.setdefault(k, []).append(v)
            em = ReduceEmitter()
            for k, vs in by_key.items():
                mr.combine(k, vs, em)
            pairs = em.pairs
        for k, v in pairs:
            combined.setdefault(k, []).append(v)

    em = MapEmitter()
    n_in_chunk = 0
    for v in vertices:
        mr.map(v, em)
        n_in_chunk += 1
        if n_in_chunk >= chunk:
            absorb(em.pairs)
            em = MapEmitter()
            n_in_chunk = 0
    absorb(em.pairs)

    if mr.has_reduce():
        rem = ReduceEmitter()
        for k, vs in combined.items():
            mr.reduce(k, vs, rem)
        grouped: dict = {}
        for k, v in rem.pairs:
            grouped.setdefault(k, []).append(v)
    else:
        grouped = combined
    return mr.finalize(grouped)


class DenseMapReduce(abc.ABC):
    """Post-superstep aggregation: one array program over the final dense
    state. ``compute`` receives the program's output arrays (numpy, shape
    [n]), the snapshot and the run's parameters."""

    memory_key: str = "mapreduce"

    @abc.abstractmethod
    def compute(self, state: dict, snapshot, params: dict): ...


class DenseProgram(abc.ABC):
    """A vertex program run as supersteps over the whole graph.

    State is a dict[str, tensor] of per-vertex arrays. Each superstep the
    engine computes::

        src_state = {k: state[k][src] for k}            # gather over edges
        msg       = self.message(src_state, edge_data)  # [E] per-edge values
        agg       = segment_<combine>(msg, dst, n)      # combine per vertex
        state'    = self.apply(state, agg, iteration)

    and stops when ``self.done(state, state', agg, iteration)`` is True or
    ``max_iterations`` is reached. ``init`` may return host arrays or CPU
    tensors; the engine moves them to its device. ``message``, ``apply``
    and ``done`` see the parameters as tensors on that device (Python
    ints as int32, floats as float32, numpy arrays as they are, float64
    and int64 narrowed to 32 bits). A ``done`` that returns the constant
    ``False`` costs no device readback.
    """

    combine: str = "sum"          # 'sum' | 'min' | 'max'
    max_iterations: int = 50

    @abc.abstractmethod
    def init(self, n: int, params: dict) -> dict: ...

    @abc.abstractmethod
    def message(self, src_state: dict, edge_data: dict, params: dict): ...

    @abc.abstractmethod
    def apply(self, state: dict, agg, iteration, params: dict) -> dict: ...

    def done(self, state: dict, new_state: dict, agg, iteration,
             params: dict):
        return False

    def edge_keys(self) -> Sequence[str]:
        """Edge property names required in the edge data (e.g. ('weight',))."""
        return ()

    def outputs(self, state: dict, params: dict) -> dict:
        """Final state → user-facing arrays (default: identity)."""
        return state
