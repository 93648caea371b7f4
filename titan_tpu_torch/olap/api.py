"""The vertex-program contract of the engine (port of ``DenseProgram``,
``DenseMapReduce`` and the classic ``MapReduce`` stage with its emitters
and ``execute_map_reduce`` in ``titan_tpu/olap/api.py``), and the job
description of the serving layer (``EdgeData``, ``JobSpec``). The dense
callbacks take and return torch tensors; a classic stage maps host
vertex views."""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


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


@dataclass
class EdgeData:
    """Per-edge arrays aligned with the snapshot's edge order."""
    values: dict = field(default_factory=dict)   # name -> array [E]


@dataclass
class JobSpec:
    """A job for the serving layer (``olap/serving``); the fields and
    defaults of the JAX package's ``JobSpec``.

    ``kind``: 'bfs' (same-snapshot BFS jobs fuse into one [K, n] batched
    run), 'sssp' | 'wcc' (same-knob jobs fuse into a cohort),
    'pagerank' (alone), 'dense' (a ``DenseProgram`` instance under
    ``params['program']``) or 'callable' (``params['fn']``, run on the
    host).

    ``deadline`` is an absolute ``time.time()`` by which the job must
    START — jobs still queued past it are EXPIRED. ``timeout_s`` bounds
    the run, checked at level and round boundaries.
    ``labels``/``edge_keys``/``directed`` select the snapshot (pool
    parameters; the port's pool holds one fixed snapshot and ignores
    them). ``directed=False`` is the default: the direction-optimizing
    BFS needs a symmetric graph.

    Recovery: ``max_retries`` lets a RUNNING job that dies requeue as
    RETRYING, with exponential backoff from ``retry_backoff_s``, up to
    that many extra attempts before FAILED; ``checkpoint_every > 0``
    (with the scheduler's ``checkpoint_dir``) captures the state every N
    round boundaries so a retried attempt resumes from the newest valid
    checkpoint, bit-equal to an uninterrupted run. Cancellation, timeout
    and parameter errors never retry.

    ``tenant`` attributes the job's queue-ms / device-seconds /
    HBM-byte-seconds / replayed rounds to a named tenant (unset or empty:
    ``"default"``). ``idempotency_key`` names the logical job across
    processes: its checkpoints are keyed by it, so a redispatch resumes
    them on its first attempt."""

    kind: str
    params: dict = field(default_factory=dict)
    priority: int = 0
    deadline: Optional[float] = None
    timeout_s: Optional[float] = None
    labels: Optional[Sequence[str]] = None
    edge_keys: Sequence[str] = ()
    directed: bool = False
    max_retries: int = 0
    checkpoint_every: int = 0
    retry_backoff_s: float = 0.05
    tenant: Optional[str] = None
    idempotency_key: Optional[str] = None


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
