"""The superstep engine: a ``DenseProgram`` run over a snapshot on one
device (port of ``titan_tpu/olap/tpu/engine.py``, single device).

Each superstep gathers every state array at ``src``, computes the
per-edge messages, combines them per destination with
``ops/segment.segment_combine`` (on a card, through the ``seg_scan``
kernel) and applies the program. The loop is a Python loop: it stops at
``max_iterations``, or when ``done`` is true, which costs one readback
per superstep unless ``done`` is the constant ``False``. The iteration
count equals the JAX package's ``run_single``.

``GPUGraphComputer`` is the counterpart of ``TPUGraphComputer`` for a
fixed snapshot. The batched engine, the checkpoint plane, classic
``MapReduce`` stages, the scheduler and the sharded engine are not
ported yet (ROADMAP queue 1, items 6, 8 and 9).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from titan_tpu_torch.device import resolve_device
from titan_tpu_torch.olap.api import DenseMapReduce, DenseProgram
from titan_tpu_torch.olap.snapshot import GraphSnapshot
from titan_tpu_torch.ops.segment import (segment_combine, segment_flags,
                                         segment_metadata)


class EngineResult(dict):
    """Final per-vertex arrays (numpy) and run metadata; DenseMapReduce
    results land in ``memory``."""

    def __init__(self, outputs: dict, iterations: int, n: int):
        super().__init__(outputs)
        self.iterations = iterations
        self.n = n
        self.memory: dict = {}


class DeviceGraph(NamedTuple):
    """A snapshot's edge arrays on one device."""
    src: torch.Tensor            # [E] int32
    dst: torch.Tensor            # [E] int32
    edge_values: dict            # name -> [E] tensor
    last_idx: torch.Tensor       # [n] int32, each segment's last edge
    seg_has: torch.Tensor        # [n] bool, segment is non-empty
    flags: torch.Tensor          # [E] bool, segment starts


def device_graph(snap: GraphSnapshot, device=None) -> DeviceGraph:
    """The snapshot's edge arrays on ``device``, uploaded once and cached
    on the snapshot (repeated runs must not pay the upload again). The
    segment-start flags are computed once here: ``dst`` is static."""
    dev = resolve_device(device)
    g = snap._device_graphs.get(dev)
    if g is None:
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        last_idx, seg_has = segment_metadata(snap.indptr_in)
        dst = up(snap.dst)
        g = DeviceGraph(up(snap.src), dst,
                        {k: up(v) for k, v in snap.edge_values.items()},
                        up(last_idx), up(seg_has), segment_flags(dst))
        snap._device_graphs[dev] = g
    return g


def _device_params(params: dict, dev: torch.device) -> dict:
    """Numeric parameters as tensors on ``dev``, typed as the JAX package
    types them with 64-bit mode off (``engine._traceable``)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, bool):
            out[k] = torch.tensor(v, device=dev)
        elif isinstance(v, int):
            out[k] = torch.tensor(v, dtype=torch.int32, device=dev)
        elif isinstance(v, float):
            out[k] = torch.tensor(v, dtype=torch.float32, device=dev)
        elif isinstance(v, np.ndarray):
            out[k] = _to_device(v, dev)
        else:
            out[k] = v
    return out


_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _to_device(a, dev: torch.device) -> torch.Tensor:
    t = torch.as_tensor(a)
    return t.to(device=dev, dtype=_NARROW.get(t.dtype, t.dtype))


def run_single(program: DenseProgram, snap: GraphSnapshot,
               params: Optional[dict] = None, device=None) -> EngineResult:
    """One DenseProgram run on one device (``None`` means CUDA)."""
    dev = resolve_device(device)
    params = dict(params or {})
    n = snap.n
    state = {k: _to_device(v, dev) for k, v in program.init(n, params).items()}
    g = device_graph(snap, dev)
    keys = program.edge_keys()
    edata = {k: g.edge_values[k] for k in keys} if keys else g.edge_values
    dparams = _device_params(params, dev)
    it = 0
    while it < program.max_iterations:
        src_state = {k: v.index_select(0, g.src) for k, v in state.items()}
        msg = program.message(src_state, edata, dparams)
        agg = segment_combine(msg, g.dst, n, program.combine,
                              last_idx=g.last_idx, seg_has=g.seg_has,
                              flags=g.flags)
        new_state = program.apply(state, agg, it, dparams)
        done = program.done(state, new_state, agg, it, dparams)
        state = new_state
        it += 1
        if done is not False and bool(done):
            break
    outputs = program.outputs(state, params)
    return EngineResult({k: v.cpu().numpy() for k, v in outputs.items()},
                        it, n)


def run_sharded(program: DenseProgram, snap: GraphSnapshot,
                params: Optional[dict] = None, devices=None):
    raise NotImplementedError(
        "run_sharded: the multi-device engine is not ported yet (ROADMAP "
        "queue 1, item 9)")


class GPUGraphComputer:
    """``graph.compute()`` on one card for a fixed snapshot: runs
    DensePrograms through ``run_single`` and then their DenseMapReduce
    stages. ``device=None`` means CUDA; the tests pass ``"cpu"``."""

    def __init__(self, snapshot: Optional[GraphSnapshot] = None,
                 device=None):
        self._default_snapshot = snapshot
        self.device = resolve_device(device)

    def snapshot(self, labels=None, edge_keys=(),
                 directed=True) -> GraphSnapshot:
        """The fixed snapshot, for the default parameters only."""
        default_args = labels is None and not tuple(edge_keys) and directed
        if self._default_snapshot is not None and default_args:
            return self._default_snapshot
        raise ValueError(
            "computer holds a fixed snapshot but this request needs "
            f"different parameters {(labels, tuple(edge_keys), directed)}; "
            "pass snapshot= explicitly (building a snapshot from a graph "
            "is not ported)")

    def run(self, program: DenseProgram, params: Optional[dict] = None,
            snapshot: Optional[GraphSnapshot] = None,
            map_reduces: Optional[list] = None, *, resume_from=None,
            checkpoint_to=None) -> EngineResult:
        if resume_from is not None or checkpoint_to is not None:
            raise NotImplementedError(
                "resume_from/checkpoint_to: the checkpoint plane is not "
                "ported yet (ROADMAP queue 1, item 6)")
        for mr in map_reduces or ():
            if not isinstance(mr, DenseMapReduce):
                raise NotImplementedError(
                    f"{type(mr).__name__}: only DenseMapReduce stages run "
                    "on the card; classic MapReduce is not ported yet "
                    "(ROADMAP queue 1, item 6)")
        snap = snapshot or self.snapshot(edge_keys=program.edge_keys())
        result = run_single(program, snap, params, device=self.device)
        for mr in map_reduces or ():
            result.memory[mr.memory_key] = mr.compute(dict(result), snap,
                                                      params or {})
        return result

    def run_batched(self, program, params_list, snapshot=None):
        raise NotImplementedError(
            "run_batched: the batched engine (run_single_batched) is not "
            "ported yet (ROADMAP queue 1, item 6)")

    def run_async(self, spec):
        raise NotImplementedError(
            "run_async: the job scheduler is not ported yet (ROADMAP "
            "queue 1, item 8)")

    def scheduler(self, **kwargs):
        raise NotImplementedError(
            "scheduler: the job scheduler is not ported yet (ROADMAP "
            "queue 1, item 8)")
