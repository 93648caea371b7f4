"""The vertex-program contract of the engine (port of ``DenseProgram`` and
``DenseMapReduce`` in ``titan_tpu/olap/api.py``). Callbacks take and
return torch tensors."""

from __future__ import annotations

import abc
from typing import Sequence


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
