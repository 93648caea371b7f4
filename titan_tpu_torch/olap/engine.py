"""The superstep engine: a ``DenseProgram`` run over a snapshot on one
device or over a vertex mesh (port of ``titan_tpu/olap/tpu/engine.py``),
its checkpoint plane, its batched run and the classic MapReduce stages.

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

``run_sharded`` runs one program over a vertex mesh
(``parallel/mesh.VertexMesh``), one process a rank: the rank holds its
``[block]`` slice of the state and its destination-owned edge block
(``parallel/partition.shard_csr``); a superstep all-gathers the state,
gathers the sources, runs ``message``, combines over the block's
``block + 1`` segments (the sink last) through ``sorted_segment_combine``
(``seg_scan`` on a card), runs ``apply`` inside ``parallel/mesh.bound``
(so ``global_sum`` spans the mesh) and all-reduces the not-done flags.

``GPUGraphComputer`` is the counterpart of ``TPUGraphComputer``: over a
graph (``graph.compute()``) it builds one snapshot per parameter set,
or it holds a fixed snapshot; ``run_async`` submits to its
``olap/serving`` ``JobScheduler``; ``num_devices`` picks the single
device or the mesh as JAX's does.

Each superstep of ``run_single`` runs under ``obs/devprof.profiled``
(``engine.superstep``; ``run_sharded``'s under
``engine.superstep_sharded``); the graph upload and the outputs'
readback count on its ``engine.graph`` and ``engine.outputs`` transfer
sites (a rank's block on ``engine.graph_sharded``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from titan_tpu_torch.device import resolve_device
from titan_tpu_torch.obs import devprof
from titan_tpu_torch.olap.api import (DenseMapReduce, DenseProgram,
                                      MapReduce, execute_map_reduce)
from titan_tpu_torch.olap.recovery import CheckpointStore
from titan_tpu_torch.olap.snapshot import GraphSnapshot
from titan_tpu_torch.ops.segment import (combine_identity, segment_combine,
                                         segment_flags, segment_metadata,
                                         sorted_segment_combine)
from titan_tpu_torch.parallel.mesh import VertexMesh, bound, vertex_mesh
from titan_tpu_torch.parallel.multihost import host_sharded
from titan_tpu_torch.parallel.partition import shard_csr

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
    cache = getattr(snap, "_device_graphs", None)
    if cache is None:             # dropped by the scheduler's eviction
        cache = snap._device_graphs = {}
    g = cache.get(dev)
    if g is None:
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        last_idx, seg_has = segment_metadata(snap.indptr_in)
        dst = up(snap.dst)
        g = DeviceGraph(up(snap.src), dst,
                        {k: up(v) for k, v in snap.edge_values.items()},
                        up(last_idx), up(seg_has), segment_flags(dst))
        devprof.count_h2d(
            "engine.graph",
            snap.src.nbytes + snap.dst.nbytes + last_idx.nbytes
            + seg_has.nbytes + sum(v.nbytes
                                   for v in snap.edge_values.values()))
        cache[dev] = g
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
            state, done_v = devprof.profiled(
                "engine.superstep", _superstep, program, state, g, edata,
                dparams, it, n)
            done = _is_done(done_v)
            it += 1
        if every > 0:
            checkpoint(it, {k: v.clone() for k, v in state.items()})
    outputs = program.outputs(state, params)
    devprof.count_d2h("engine.outputs",
                      sum(v.numel() * v.element_size()
                          for v in outputs.values()))
    return EngineResult(_host(outputs), it, n)


def _superstep(program: DenseProgram, state: dict, g: DeviceGraph,
               edata: dict, dparams: dict, it: int, n: int):
    """One superstep of ``run_single``: ``(new_state, done)``, ``done``
    as the program returns it (not read back here)."""
    src_state = {k: v.index_select(0, g.src) for k, v in state.items()}
    msg = program.message(src_state, edata, dparams)
    agg = segment_combine(msg, g.dst, n, program.combine,
                          last_idx=g.last_idx, seg_has=g.seg_has,
                          flags=g.flags)
    new_state = program.apply(state, agg, it, dparams)
    return new_state, program.done(state, new_state, agg, it, dparams)


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


class ShardedBlock(NamedTuple):
    """A rank's engine block on its device (``parallel/partition.
    shard_csr``'s row of the rank)."""
    n: int
    n_pad: int
    block: int
    src: torch.Tensor            # [e_block] int32, global sources
    dst: torch.Tensor            # [e_block] int32 in [0, block]; block = sink
    valid: torch.Tensor          # [e_block] bool
    last_idx: torch.Tensor       # [block + 1] int32
    seg_has: torch.Tensor        # [block + 1] bool
    flags: torch.Tensor          # [e_block] bool, segment starts
    edge_values: dict            # name -> [e_block] tensor


def sharded_block(snap: GraphSnapshot, mesh: VertexMesh) -> ShardedBlock:
    """This rank's block of ``snap``, packed and uploaded once and cached
    as ``snap._sharded_csr_by_mesh[mesh.key]``."""
    cache = getattr(snap, "_sharded_csr_by_mesh", None)
    if cache is None:
        cache = snap._sharded_csr_by_mesh = {}
    got = cache.get(mesh.key)
    if got is None:
        sc = shard_csr(snap, mesh.world, ranks=(mesh.rank,))
        names = sorted(sc.edge_values)
        up = host_sharded(mesh, lambda d: (
            sc.src_global[0], sc.dst_local[0], sc.valid[0], sc.last_idx[0],
            sc.seg_has[0], *(sc.edge_values[k][0] for k in names)))
        got = ShardedBlock(sc.n, sc.n_pad, sc.block, *up[:5],
                           segment_flags(up[1]), dict(zip(names, up[5:])))
        devprof.count_h2d("engine.graph_sharded",
                          sum(v.numel() * v.element_size() for v in up))
        cache[mesh.key] = got
    return got


def run_sharded(program: DenseProgram, snap: GraphSnapshot,
                params: Optional[dict], mesh: VertexMesh) -> EngineResult:
    """One DenseProgram over the vertex mesh; every rank calls it with
    the same arguments and gets the whole result. The rank's state is its
    ``[block]`` slice of the state padded to ``n_pad`` (zeros past ``n``,
    as JAX pads it). The loop stops at ``max_iterations`` or when every
    rank's ``done`` holds: one ``all_reduce(SUM)`` of the not-done flags
    a superstep, whatever ``done`` returns (a rank's ``False`` may be
    another's ``True``), and one readback. The final state is
    all-gathered for ``outputs``."""
    params = dict(params or {})
    dev = mesh.device
    g = sharded_block(snap, mesh)
    n, n_pad, block = g.n, g.n_pad, g.block
    lo = mesh.rank * block
    state = {}
    for k, v in program.init(n, params).items():
        v = _to_device(v, dev)
        pad = v.new_zeros((n_pad - n,) + tuple(v.shape[1:]))
        state[k] = torch.cat([v, pad])[lo:lo + block].clone()
    keys = program.edge_keys()
    edata = {k: v for k, v in g.edge_values.items() if not keys or k in keys}
    dparams = _device_params(params, dev)
    it, done = 0, False
    with bound(mesh):
        while it < program.max_iterations and not done:
            state, done = devprof.profiled(
                "engine.superstep_sharded", _sharded_superstep, program,
                state, g, edata, dparams, it, mesh)
            it += 1
    full = {k: mesh.all_gather(v).flatten(0, 1)[:n] for k, v in state.items()}
    outputs = program.outputs(full, params)
    return EngineResult(_host(outputs), it, n)


def _sharded_superstep(program: DenseProgram, state: dict, g: ShardedBlock,
                       edata: dict, dparams: dict, it: int,
                       mesh: VertexMesh):
    """One superstep of ``run_sharded``: ``(new_state, done)``, ``done``
    agreed by every rank."""
    full = {k: mesh.all_gather(v).flatten(0, 1) for k, v in state.items()}
    src_state = {k: v.index_select(0, g.src) for k, v in full.items()}
    del full
    msg = program.message(src_state, edata, dparams)
    msg = torch.where(g.valid, msg,
                      msg.new_full((), combine_identity(program.combine,
                                                        msg.dtype)))
    agg = sorted_segment_combine(msg, g.dst, g.last_idx, g.seg_has,
                                 program.combine, flags=g.flags)[:g.block]
    new_state = program.apply(state, agg, it, dparams)
    local = program.done(state, new_state, agg, it, dparams)
    not_done = torch.logical_not(torch.as_tensor(local, device=mesh.device))
    return new_state, mesh.all_reduce(not_done.to(torch.int32),
                                      "sum").item() == 0


class GPUGraphComputer:
    """``graph.compute()``: runs DensePrograms through ``run_single``
    (optionally checkpointed) or, over several ranks, ``run_sharded``,
    and then their MapReduce stages, or K parameter sets at once through
    ``run_single_batched``, over snapshots built from ``graph`` (one per
    parameter set) or over a fixed ``snapshot``. ``device=None`` means
    CUDA; the tests pass ``"cpu"``.

    ``num_devices`` is JAX's: 1 runs ``run_single``; more runs
    ``run_sharded`` over ``vertex_mesh(num_devices, device=device)``,
    which needs an initialised process group of that size with the
    device's default backend (NCCL on a card, gloo on the CPU; ranks
    sharing one card over gloo call ``run_sharded`` with their own
    mesh); 0 takes the initialised group's size, or 1 without one."""

    def __init__(self, graph=None, snapshot: Optional[GraphSnapshot] = None,
                 device=None, num_devices: int = 0):
        self.graph = graph
        self._default_snapshot = snapshot
        self._built: dict[tuple, GraphSnapshot] = {}
        self.device = resolve_device(device)
        self.num_devices = num_devices
        self._scheduler = None

    def _devices(self) -> int:
        """The mesh size ``run`` uses: ``num_devices``, or for 0 the
        initialised group's size (1 without a group)."""
        if self.num_devices > 0:
            return self.num_devices
        return dist.get_world_size() if dist.is_initialized() else 1

    def snapshot(self, labels=None, edge_keys=(),
                 directed=True) -> GraphSnapshot:
        """The snapshot for these parameters, cached per parameter set (a
        directed snapshot never answers a symmetrized request). A fixed
        snapshot answers the default parameters only."""
        default_args = labels is None and not tuple(edge_keys) and directed
        if self._default_snapshot is not None and default_args:
            return self._default_snapshot
        key = (tuple(labels) if labels is not None else None,
               tuple(edge_keys), directed)
        snap = self._built.get(key)
        if snap is None:
            if self.graph is None:
                raise ValueError(
                    "computer holds a fixed snapshot but this request "
                    f"needs different parameters {key}; pass snapshot= "
                    "explicitly or construct the computer from a graph")
            from titan_tpu_torch.olap.snapshot import build
            snap = build(self.graph, labels=labels, edge_keys=edge_keys,
                         directed=directed)
            self._built[key] = snap
        return snap

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
        run; a resumed run writes its checkpoints as the next attempt.
        Checkpoints need the single-device engine (``num_devices`` 1)."""
        if map_reduces:
            _check_map_reduces(map_reduces)
        snap = snapshot or self.snapshot(edge_keys=program.edge_keys())
        ndev = self._devices()
        if resume_from is None and checkpoint_to is None and ndev != 1:
            result = run_sharded(program, snap, params,
                                 vertex_mesh(ndev, device=self.device))
            if map_reduces:
                self._run_map_reduces(map_reduces, result, snap,
                                      params or {})
            return result
        if ndev != 1:
            raise ValueError("resume_from/checkpoint_to need the single-"
                             "device engine (set num_devices=1)")
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

    def scheduler(self, **kwargs):
        """The computer's job scheduler (``olap/serving.JobScheduler``) on
        its device, created on first use and shared by every
        ``run_async`` call. Over a graph its pool builds and refreshes a
        snapshot per job's labels and orientation; only a graph-less
        computer serves its fixed snapshot, which ignores a job's
        snapshot parameters, so the caller makes it fit the jobs
        (symmetric for BFS)."""
        if self._scheduler is None or self._scheduler.closed:
            from titan_tpu_torch.olap.serving.scheduler import JobScheduler
            self._scheduler = JobScheduler(
                graph=self.graph,
                snapshot=None if self.graph is not None
                else self._default_snapshot,
                device=self.device, **kwargs)
        return self._scheduler

    def run_async(self, spec):
        """Submit a ``JobSpec`` (``olap/api.py``) to this computer's
        scheduler; returns the ``Job`` handle at once."""
        return self.scheduler().submit(spec)
