"""The superstep engine: a ``DenseProgram`` run over a snapshot on one
device (port of ``titan_tpu/olap/tpu/engine.py``, single device), its
checkpoint plane, its batched run and the classic MapReduce stages.

Each superstep gathers every state array at ``src``, computes the
per-edge messages, combines them per destination with
``ops/segment.segment_combine`` (on a card, through the ``seg_scan``
kernel) and applies the program. The loop is a Python loop: it stops at
``max_iterations``, or when ``done`` is true, which costs one readback
per superstep unless ``done`` is the constant ``False``. The iteration
count equals the JAX package's ``run_single``.

The checkpoint plane (``run_single(checkpoint=, checkpoint_every=,
resume=)``, ``GPUGraphComputer.run(checkpoint_to=, resume_from=)``) runs
the loop in chunks that end on multiples of the cadence and hands each
chunk's state to the callback; each superstep depends only on the state
and the absolute iteration, so chunked and resumed runs are bit-equal to
one uninterrupted run. Checkpoints go through ``olap/recovery``, in the
JAX package's on-disk format.

``run_single_batched`` runs K parameter sets of one program with
``[K, n]`` state: one gather of the state at ``src`` a superstep, each
live job's ``message``, ``apply`` and ``done`` on its own row (the
expressions of ``run_single``), and one ``seg_scan`` launch over the K
rows of messages. A job that reports done freezes.

``GPUGraphComputer`` is the counterpart of ``TPUGraphComputer`` for a
fixed snapshot. The scheduler and the sharded engine are not ported yet
(ROADMAP queue 1, items 8 and 9); nor is building a snapshot from a
graph (item 6b).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from titan_tpu_torch.device import resolve_device
from titan_tpu_torch.olap.api import (DenseMapReduce, DenseProgram,
                                      MapReduce, execute_map_reduce)
from titan_tpu_torch.olap.recovery import CheckpointStore
from titan_tpu_torch.olap.snapshot import GraphSnapshot
from titan_tpu_torch.ops.segment import (segment_combine, segment_flags,
                                         segment_metadata,
                                         sorted_segment_combine)

#: store job id under which GPUGraphComputer.run's own checkpoints live
#: (the JAX package's: one run a checkpoint directory)
_RUN_CKPT_ID = "run"


class EngineResult(dict):
    """Final per-vertex arrays (numpy) and run metadata; DenseMapReduce
    results land in ``memory``."""

    def __init__(self, outputs: dict, iterations: int, n: int):
        super().__init__(outputs)
        self.iterations = iterations
        self.n = n
        self.memory: dict = {}


class _DenseVertexView:
    """Minimal vertex view over dense output arrays for classic MapReduce
    stages run against an engine result (state reads only; adjacency would
    need the OLTP tx and is out of scope for post-BSP aggregation)."""

    __slots__ = ("_snap", "_state", "_di")

    def __init__(self, snap, state: dict, di: int):
        self._snap = snap
        self._state = state
        self._di = di

    @property
    def id(self) -> int:
        return int(self._snap.vertex_ids[self._di])

    def get_state(self, key: str, default=None):
        arr = self._state.get(key)
        if arr is None:
            return default
        return arr[self._di].item() if arr.ndim == 1 else arr[self._di]

    def value(self, key: str, default=None):
        return self.get_state(key, default)


def _check_map_reduces(map_reduces) -> None:
    """Reject stages that are neither DenseMapReduce nor MapReduce, and
    duplicate memory keys (two stages sharing a key would silently
    overwrite each other's result), before the run."""
    seen = set()
    for mr in map_reduces:
        if not isinstance(mr, (DenseMapReduce, MapReduce)):
            raise TypeError(
                f"{type(mr).__name__} is not a supported MapReduce stage "
                "here (need DenseMapReduce/MapReduce)")
        if mr.memory_key in seen:
            raise ValueError(
                f"duplicate MapReduce memory_key {mr.memory_key!r}")
        seen.add(mr.memory_key)


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


def _edge_data(program: DenseProgram, g: DeviceGraph) -> dict:
    keys = program.edge_keys()
    return {k: g.edge_values[k] for k in keys} if keys else g.edge_values


def _is_done(done) -> bool:
    """A ``done`` result as a bool; the constant False costs no readback."""
    return done is not False and bool(done)


def _host(outputs: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in outputs.items()}


def run_single(program: DenseProgram, snap: GraphSnapshot,
               params: Optional[dict] = None, device=None, *,
               resume: Optional[dict] = None, checkpoint=None,
               checkpoint_every: int = 0) -> EngineResult:
    """One DenseProgram run on one device (``None`` means CUDA).

    With ``checkpoint_every > 0`` the loop runs in chunks that end at the
    next multiple of the cadence (whatever the resume point, so the
    checkpoint rounds are stable identifiers), at a convergence inside a
    chunk, or at ``max_iterations``, and ``checkpoint(iteration, state)``
    fires at every chunk end with a copy of the state (the callback owns
    readback and persistence). ``resume={"state": {...}, "iteration":
    i}`` continues from a captured boundary; its arrays go to the device
    narrowed as ``init``'s are."""
    dev = resolve_device(device)
    params = dict(params or {})
    n = snap.n
    if resume is not None:
        state = {k: _to_device(v, dev) for k, v in resume["state"].items()}
        it = int(resume["iteration"])
    else:
        state = {k: _to_device(v, dev)
                 for k, v in program.init(n, params).items()}
        it = 0
    g = device_graph(snap, dev)
    edata = _edge_data(program, g)
    dparams = _device_params(params, dev)
    max_iter = program.max_iterations
    every = int(checkpoint_every or 0) if checkpoint is not None else 0
    done = False
    while it < max_iter and not done:
        it_end = min(max_iter, (it // every + 1) * every) if every > 0 \
            else max_iter
        while it < it_end and not done:
            src_state = {k: v.index_select(0, g.src)
                         for k, v in state.items()}
            msg = program.message(src_state, edata, dparams)
            agg = segment_combine(msg, g.dst, n, program.combine,
                                  last_idx=g.last_idx, seg_has=g.seg_has,
                                  flags=g.flags)
            new_state = program.apply(state, agg, it, dparams)
            done = _is_done(program.done(state, new_state, agg, it, dparams))
            state = new_state
            it += 1
        if every > 0:
            checkpoint(it, {k: v.clone() for k, v in state.items()})
    outputs = program.outputs(state, params)
    return EngineResult(_host(outputs), it, n)


def _row_buffer(k: int, n: int, dtype, dev) -> torch.Tensor:
    """An uninitialised ``[k, n]`` view of ``[k, n rounded up to 4]``:
    every row starts 16-byte aligned, as a tensor of its own does, so the
    card's vectorized reductions add a row in the order they add a
    one-job array."""
    return torch.empty((k, -(-n // 4) * 4), dtype=dtype, device=dev)[:, :n]


def _job_rows(arrays: list) -> torch.Tensor:
    """K per-job arrays as one ``[K, ...]`` tensor (1-d ones in a
    ``_row_buffer``)."""
    first = arrays[0]
    if first.dim() != 1:
        return torch.stack(arrays)
    out = _row_buffer(len(arrays), first.shape[0], first.dtype, first.device)
    for k, a in enumerate(arrays):
        out[k].copy_(a)
    return out


def _batched_messages(program: DenseProgram, state: dict, g: DeviceGraph,
                      edata: dict, dparams: list, live: list, buf):
    """Each live job's messages, written into its row of ``buf`` [K, ld]
    (ld = E rounded up to 4 elements, allocated at the first call). The
    state is gathered at ``src`` once for all K jobs; the gathered
    ``[K, E]`` arrays die on return, before the scan allocates its
    output."""
    e = g.src.shape[0]
    gathered = {k: v.index_select(1, g.src) for k, v in state.items()}
    for j in live:
        msg = program.message({k: v[j] for k, v in gathered.items()},
                              edata, dparams[j])
        if buf is None or buf.dtype != msg.dtype:
            k_jobs = len(dparams)
            buf = torch.empty((k_jobs, -(-e // 4) * 4), dtype=msg.dtype,
                              device=msg.device)
        buf[j, :e].copy_(msg)
    return buf


def run_single_batched(program: DenseProgram, snap: GraphSnapshot,
                       params_list, device=None) -> list:
    """Run ONE DenseProgram for K parameter sets (e.g. K BFS sources) as
    one batched run with ``[K, n]`` state; returns one ``EngineResult`` a
    job (MapReduce stages are not run here). Params must be numeric
    (int/float/bool/ndarray) and share a key set.

    A superstep gathers the state of the live jobs at ``src`` once, runs
    each live job's ``message`` on its row with its own device params
    into a ``[K, ld]`` buffer, combines every row with one ``seg_scan``
    launch, and runs each live job's ``apply`` and ``done`` on its row
    (one readback a live job unless ``done`` is the constant False). A
    job that reports done freezes; the loop ends when every job is done
    or at ``max_iterations``. Each job evaluates exactly the expressions
    of ``run_single`` on its row, and each row of the scan is bit-equal
    to the one-row scan, so every job's result and iteration count equal
    its ``run_single`` run."""
    params_list = [dict(p or {}) for p in params_list]
    if not params_list:
        raise ValueError("run_single_batched needs >= 1 params set")
    keys = set(params_list[0])
    for p in params_list[1:]:
        if set(p) != keys:
            raise ValueError("batched jobs must share a params key set")
    for p in params_list:
        for k, v in p.items():
            if not isinstance(v, (int, float, bool, np.ndarray)):
                raise TypeError(
                    f"run_single_batched params must be numeric; "
                    f"{k!r} is {type(v).__name__}")
    dev = resolve_device(device)
    n = snap.n
    inits = [{k: _to_device(v, dev) for k, v in program.init(n, p).items()}
             for p in params_list]
    state = {k: _job_rows([s[k] for s in inits]) for k in inits[0]}
    del inits
    g = device_graph(snap, dev)
    edata = _edge_data(program, g)
    dparams = [_device_params(p, dev) for p in params_list]
    n_jobs = len(params_list)
    done = [False] * n_jobs
    it_done = [0] * n_jobs
    buf = agg = None
    it = 0
    while it < program.max_iterations and not all(done):
        live = [j for j in range(n_jobs) if not done[j]]
        buf = _batched_messages(program, state, g, edata, dparams, live, buf)
        if agg is None or agg.dtype != buf.dtype:
            agg = _row_buffer(n_jobs, n, buf.dtype, dev)
        sorted_segment_combine(buf, g.dst, g.last_idx, g.seg_has,
                               program.combine, flags=g.flags, out=agg)
        storages = {v.untyped_storage().data_ptr() for v in state.values()}
        for j in live:
            row = {k: v[j] for k, v in state.items()}
            new = program.apply(row, agg[j], it, dparams[j])
            if _is_done(program.done(row, new, agg[j], it, dparams[j])):
                done[j] = True
                it_done[j] = it + 1
            # a new array that is a row of the state is copied out first,
            # so that no copy reads a row another copy has overwritten
            writes = [(state[k][j], v.clone() if v.untyped_storage()
                       .data_ptr() in storages else v)
                      for k, v in new.items()
                      if v.data_ptr() != state[k][j].data_ptr()]
            for dst, v in writes:
                dst.copy_(v)
        it += 1
    return [EngineResult(
        _host(program.outputs({k: v[j] for k, v in state.items()}, p)),
        it_done[j] or it, n) for j, p in enumerate(params_list)]


def run_sharded(program: DenseProgram, snap: GraphSnapshot,
                params: Optional[dict] = None, devices=None):
    raise NotImplementedError(
        "run_sharded: the multi-device engine is not ported yet (ROADMAP "
        "queue 1, item 9)")


class GPUGraphComputer:
    """``graph.compute()`` on one card for a fixed snapshot: runs
    DensePrograms through ``run_single`` (optionally checkpointed) and
    then their MapReduce stages, or K parameter sets at once through
    ``run_single_batched``. ``device=None`` means CUDA; the tests pass
    ``"cpu"``."""

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
            "is not ported yet: ROADMAP queue 1, item 6b)")

    def run(self, program: DenseProgram, params: Optional[dict] = None,
            snapshot: Optional[GraphSnapshot] = None,
            map_reduces: Optional[list] = None, *,
            resume_from: Optional[str] = None,
            checkpoint_to: Optional[str] = None,
            checkpoint_every: int = 0) -> EngineResult:
        """Run a DenseProgram, then its MapReduce stages (validated before
        the run). ``checkpoint_to`` with ``checkpoint_every > 0`` writes a
        digest-verified checkpoint every N iterations (job id ``"run"``,
        kind ``"dense"``); ``resume_from`` reloads the newest VALID
        checkpoint under that path (a torn or corrupted one is skipped by
        digest) and continues the loop, bit-equal to an uninterrupted
        run; a resumed run writes its checkpoints as the next attempt."""
        if map_reduces:
            _check_map_reduces(map_reduces)
        snap = snapshot or self.snapshot(edge_keys=program.edge_keys())
        resume = ck = None
        if resume_from is not None:
            ck = CheckpointStore(resume_from).latest(_RUN_CKPT_ID)
            if ck is not None and ck.kind == "dense":
                resume = {"state": ck.arrays, "iteration": ck.round}
        ckpt_cb = None
        if checkpoint_to is not None and checkpoint_every > 0:
            store = CheckpointStore(checkpoint_to)
            attempt = ck.attempt + 1 if resume is not None else 1

            def ckpt_cb(it, state):
                store.save(_RUN_CKPT_ID, attempt=attempt, round_=it,
                           kind="dense", arrays=_host(state))
        result = run_single(program, snap, params, device=self.device,
                            resume=resume, checkpoint=ckpt_cb,
                            checkpoint_every=checkpoint_every)
        if map_reduces:
            self._run_map_reduces(map_reduces, result, snap, params or {})
        return result

    def run_batched(self, program: DenseProgram, params_list,
                    snapshot: Optional[GraphSnapshot] = None) -> list:
        """K parameter sets of one DenseProgram as one ``[K, n]`` batched
        run (``run_single_batched``)."""
        snap = snapshot or self.snapshot(edge_keys=program.edge_keys())
        return run_single_batched(program, snap, params_list,
                                  device=self.device)

    @staticmethod
    def _run_map_reduces(map_reduces, result: EngineResult,
                         snap: GraphSnapshot, params: dict) -> None:
        """Post-BSP MapReduce stages (reference:
        FulgoraGraphComputer.java:192-246). DenseMapReduce runs as one
        array program over the output arrays; classic MapReduce iterates
        host vertex views over them."""
        host_state = None
        for mr in map_reduces:
            if isinstance(mr, DenseMapReduce):
                result.memory[mr.memory_key] = mr.compute(dict(result), snap,
                                                          params)
                continue
            if host_state is None:
                host_state = {k: np.asarray(v) for k, v in result.items()}
            views = (_DenseVertexView(snap, host_state, di)
                     for di in range(snap.n))
            result.memory[mr.memory_key] = execute_map_reduce(mr, views)

    def run_async(self, spec):
        raise NotImplementedError(
            "run_async: the job scheduler is not ported yet (ROADMAP "
            "queue 1, item 8)")

    def scheduler(self, **kwargs):
        raise NotImplementedError(
            "scheduler: the job scheduler is not ported yet (ROADMAP "
            "queue 1, item 8)")
