"""The vertex mesh over ``torch.distributed`` (port of
``titan_tpu/parallel/mesh.py``).

The JAX package shards per-vertex state over a 1-D mesh axis ``"v"`` and
exchanges it with collectives inside ``shard_map`` bodies. PyTorch has
no SPMD compiler: the port runs one process a rank, each running the
same host loop on its own shard, with the collectives as explicit calls.
The host loops are deterministic given replicated values, so every rank
takes the same branches and issues the same collectives in the same
order.

| JAX (``titan_tpu/parallel/mesh.py``, ``partition.py``, ``multihost.py``) | the port |
| --- | --- |
| ``Mesh`` over D devices, axis ``"v"`` (``vertex_mesh``) | ``VertexMesh``: rank, world size, device and backend of the default process group. ``vertex_mesh(num_devices=None, device=None, backend=None)`` needs an initialised group of exactly that size and raises otherwise; ``None`` takes the group's size. A CUDA device defaults to NCCL, ``"cpu"`` to gloo |
| a ``shard_map`` body | plain code that runs on this rank's shard |
| ``all_gather``, ``pmax``, ``psum``, ``pmin`` over ``"v"`` | ``VertexMesh.all_gather`` (``dist.all_gather``, list form) and ``VertexMesh.all_reduce`` (``dist.all_reduce`` with ``MAX``, ``SUM`` or ``MIN``) |
| ``place_shards`` / ``NamedSharding(P("v", ...))`` | each rank packs and uploads only its own block (``multihost.host_sharded``, e.g. of ``pack_shard_block(rank, ...)``) |
| ``place_replicated`` | every rank holds the same tensor (``multihost.host_replicated``) |
| ``mesh_jit`` and its compile buckets | none: PyTorch runs eagerly. A level still reads its stats back once, plus once a retry of the exchange |
| ``bound_axes`` / ``axis_bound`` / ``global_sum`` | ``bound(mesh)``, a context that ``engine.run_sharded`` sets around its loop; ``global_sum`` all-reduces inside it and sums plainly outside it, and raises where JAX raises: a bound but different axis |
| ``multihost.init`` / ``global_mesh`` | ``multihost.init``: ``init_process_group(backend, init_method="file://...", rank, world_size)`` over a file rendezvous (no network), then ``vertex_mesh()`` over the whole group; ``multihost.launch(fn, world, device, backend, args)`` spawns the ranks and returns rank 0's result |
| ``host_sharded`` / ``host_replicated`` | a rank fills only its own block, from host arrays or ``np.load(mmap_mode="r")`` files |
| the serving plane's one-process ``Mesh`` (``JobScheduler(mesh=)``, ``place_batched_csr``; ``mesh.devices.size``) | ``LocalMesh``: one process driving its local devices, ``local_mesh(devices=None)``; ``LocalMesh.size`` stands for ``mesh.devices.size``. Devices may repeat: several shards on one card, or on the CPU |

``mesh_key`` becomes ``VertexMesh.key``, ``(device, world, rank)``: the
key of the port's per-rank caches on a snapshot or a graph dict. A
``LocalMesh`` is its own key (a frozen dataclass of its devices).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from titan_tpu_torch.device import cache_key

VERTEX_AXIS = "v"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


@dataclass(frozen=True)
class VertexMesh:
    """This rank's view of a 1-D vertex mesh over the default process
    group: its rank, the world size, the device it computes on and the
    group's backend. ``axis`` names the mesh axis for ``global_sum``.

    With gloo and a CUDA device (several ranks sharing one card), each
    collective copies its buffer to the host and the result back: gloo
    reduces host memory only. NCCL runs on the card."""

    rank: int
    world: int
    device: torch.device
    backend: str
    axis: str = VERTEX_AXIS

    @property
    def key(self) -> tuple:
        """The key of this rank's caches: ``(device, world, rank)``."""
        return (self.device, self.world, self.rank)

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """A private contiguous copy of ``t`` where the backend reduces:
        the host for gloo, the device otherwise."""
        if self.backend == "gloo" and t.device.type != "cpu":
            return t.detach().to("cpu").contiguous()
        return t.detach().clone().contiguous()

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along a new leading axis, ``[world,
        *t.shape]``, on this rank's device. Bool tensors travel as
        uint8 (gloo has no bool)."""
        boolean = t.dtype == torch.bool
        x = self._staged(t.view(torch.uint8) if boolean else t).reshape(-1)
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        out = torch.stack(parts).to(self.device).view(self.world, *t.shape)
        return out.view(torch.bool) if boolean else out

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced over the ranks with ``op`` (``"sum"``, ``"max"``
        or ``"min"``), as a new tensor on this rank's device; ``t`` is
        left as it was."""
        x = self._staged(t).reshape(-1)
        dist.all_reduce(x, op=_OPS[op])
        return x.to(self.device).view(t.shape)


def vertex_mesh(num_devices: Optional[int] = None, device=None,
                backend: Optional[str] = None) -> VertexMesh:
    """This rank's mesh over the initialised default process group.

    ``num_devices`` must equal the group's size (``None`` or ``<= 0``
    takes it). ``device`` is resolved as every entry point resolves it
    (``None`` means CUDA). ``backend`` is the group's expected backend:
    by default NCCL for a CUDA device and gloo for the CPU; several
    ranks on one card pass ``"gloo"``. Raises ``RuntimeError`` without
    an initialised group and ``ValueError`` on a mismatch."""
    dev = cache_key(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "vertex_mesh needs an initialised process group: call "
            "parallel.multihost.init in every rank, or run the ranks "
            "through parallel.multihost.launch")
    world = dist.get_world_size()
    if num_devices is None or num_devices <= 0:
        num_devices = world
    if num_devices != world:
        raise ValueError(f"requested {num_devices} devices, the process "
                         f"group has {world} ranks")
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"the process group runs {have!r}, the mesh "
                         f"expects {want!r} on {dev}; pass backend="
                         f"{have!r} to use it")
    if have == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL reduces CUDA tensors only; a CPU mesh "
                         "runs over gloo")
    return VertexMesh(dist.get_rank(), world, dev, have)


@dataclass(frozen=True)
class LocalMesh:
    """The serving plane's mesh: one process driving ``devices``, a
    tuple of ``torch.device`` (the mesh-placed batched BFS puts one
    vertex block on each, ``parallel/partition.place_batched_csr``).
    A device may appear more than once: its blocks then share it."""

    devices: tuple

    @property
    def size(self) -> int:
        """The number of blocks (JAX's ``mesh.devices.size``)."""
        return len(self.devices)


def local_mesh(devices: Optional[Sequence] = None) -> LocalMesh:
    """A ``LocalMesh`` over ``devices`` (names or ``torch.device``s, each
    resolved as every entry point resolves a device; a CUDA device
    without an index is the current one), or over every visible CUDA
    device when ``None``, which raises without one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "local_mesh() takes every visible CUDA device and there is "
                "none; pass devices=['cpu', ...] to run on the host")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(cache_key(d) for d in devices)
    if not devs:
        raise ValueError("local_mesh needs at least one device")
    return LocalMesh(devs)


#: the mesh of the sharded run this thread is inside, if any
_BOUND: contextvars.ContextVar = contextvars.ContextVar(
    "titan_tpu_torch_bound_mesh", default=None)


@contextlib.contextmanager
def bound(mesh: VertexMesh):
    """Bind ``mesh``'s axis for the code inside (the counterpart of a
    ``shard_map`` body's axis environment): ``global_sum`` reduces over
    it there."""
    token = _BOUND.set(mesh)
    try:
        yield mesh
    finally:
        _BOUND.reset(token)


def bound_axes() -> tuple:
    """Names of the mesh axes bound here: ``(mesh.axis,)`` inside
    ``bound(mesh)``, else empty."""
    mesh = _BOUND.get()
    return () if mesh is None else (mesh.axis,)


def axis_bound(name: str = VERTEX_AXIS) -> bool:
    """True iff mesh axis ``name`` is bound here."""
    return name in bound_axes()


def global_sum(x: torch.Tensor, axis: str = VERTEX_AXIS) -> torch.Tensor:
    """Sum across the whole vertex axis from inside a DenseProgram
    callback: the shard's sum all-reduced over the mesh inside a sharded
    run, a plain sum outside one. Programs with global reductions (HITS's
    normalisation) must use it, or a sharded run normalises each shard on
    its own. A bound mesh whose axis is not ``axis`` raises: a misspelled
    axis must never become a per-shard sum."""
    total = x.sum()
    mesh = _BOUND.get()
    if mesh is None:
        return total
    if mesh.axis != axis:
        raise ValueError(
            f"global_sum over axis {axis!r}, but the bound mapped axes are "
            f"{bound_axes()} — a per-shard sum here would be silently "
            "wrong; pass the mesh axis this program is sharded over")
    return mesh.all_reduce(total, "sum")
