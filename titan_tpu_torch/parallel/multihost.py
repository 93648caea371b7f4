"""Process groups, the rank launcher and host-sharded loading (port of
``titan_tpu/parallel/multihost.py``).

Every rank calls :func:`init`, all ranks run the same program over the
mesh of ``parallel/mesh.vertex_mesh``, and graph arrays reach a rank's device
through :func:`host_sharded` / :func:`host_replicated`, so a rank fills
only its own block (from host arrays, or from ``np.load(mmap_mode="r")``
files, of which it reads only its pages). The sharded BFS's host loop is
deterministic given its replicated stats, so every rank takes the same
branches.

:func:`launch` spawns the ranks of one program on this host (the
``spawn`` start method; a file rendezvous in a fresh temporary
directory, no network) and returns rank 0's result.
``python -m titan_tpu_torch.parallel.multihost`` runs the multi-process
dry run: the sharded hybrid BFS with host-sharded loading, checked bit
for bit by rank 0 against the single-card ``frontier_bfs_hybrid``; it
prints one ``MULTIHOST_OK {...}`` line and exits 2 on a difference.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from titan_tpu_torch.parallel.mesh import VertexMesh, vertex_mesh


def init(rendezvous: str, num_processes: int, process_id: int,
         backend: str = "nccl", device=None) -> None:
    """Join the process group (once a process, before any collective).
    ``rendezvous`` is a file path every rank shares; the file must not
    exist before the group forms. With NCCL the rank's CUDA device
    (``device``, default ``cuda:<process_id>``) becomes the current one."""
    if backend == "nccl":
        torch.cuda.set_device(torch.device("cuda", process_id)
                              if device is None else torch.device(device))
    dist.init_process_group(backend, init_method="file://" + rendezvous,
                            rank=process_id, world_size=num_processes)


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _upload(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def host_sharded(mesh: VertexMesh, fill: Callable[[int], object]):
    """This rank's block on its device: ``fill(rank)`` is called for this
    rank only and returns an array or a tuple of arrays, each uploaded
    (a tuple comes back as a tuple of tensors)."""
    block = fill(mesh.rank)
    if isinstance(block, tuple):
        return tuple(_upload(a, mesh.device) for a in block)
    return _upload(block, mesh.device)


def host_replicated(mesh: VertexMesh, value) -> torch.Tensor:
    """The same array on every rank's device."""
    return _upload(value, mesh.device)


def _rank_device(device, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def _rank_main(rank: int, world: int, rendezvous: str, backend: str,
               device: str, fn, args: tuple, results) -> None:
    try:
        dev = _rank_device(device, rank)
        init(rendezvous, world, rank, backend, dev)
        out = fn(vertex_mesh(world, dev, backend), *args)
        results.put((rank, True, out if rank == 0 else None))
    except Exception:      # reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def launch(fn, world: int, device="cuda", backend: Optional[str] = None,
           args: tuple = (), timeout: float = 1800.0):
    """Run ``fn(mesh, *args)`` in ``world`` spawned ranks and return rank
    0's result. ``fn`` must be importable by name (a module-level
    function) and its arguments and rank 0's result picklable. The
    backend defaults to NCCL for a CUDA device and gloo for the CPU. A
    CUDA device without an index gives rank r the card ``cuda:r``; any
    other device, ``cuda:0`` included, is shared by every rank. A rank
    that raises or dies makes the launcher end every rank and raise
    ``RuntimeError`` with that rank's traceback; so does ``timeout``
    seconds passing."""
    import torch.multiprocessing as mp

    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="titan_tpu_torch_mesh_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, os.path.join(tmp, "rendezvous"), backend, str(device), fn,
        tuple(args), results)) for r in range(world)]
    got: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < world:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with "
                                       f"{dead[0][1]} before reporting")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the {world} ranks did not finish "
                                       f"in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return got[0]


def run_multihost_bfs(host_graph: dict, source_dense: int,
                      mesh: VertexMesh, max_levels: int = 1000):
    """The sharded hybrid BFS with host-sharded loading: each rank packs
    and uploads only its own block of ``host_graph`` (the graph500-style
    host dict: ``n``, ``q_total``, ``deg``, ``colstart``, ``dstT`` numpy
    arrays, memory-mapped or not). Every rank calls it with the same
    arguments; returns ``(dist np [n], levels)`` on every rank."""
    from titan_tpu_torch.models import bfs_hybrid_sharded as S

    return S.frontier_bfs_hybrid_sharded(host_graph, source_dense, mesh,
                                         max_levels=max_levels)


def _worker(mesh: VertexMesh, scale: int) -> dict:
    """One rank of the dry run: builds the same symmetric R-MAT graph as
    every peer, runs the host-sharded BFS over the mesh, and on rank 0
    checks it bit for bit against the single-card hybrid. Returns rank
    0's record."""
    from titan_tpu_torch.models import bfs_hybrid_sharded as S
    from titan_tpu_torch.models.bfs_hybrid import (chunked_layout,
                                                   frontier_bfs_hybrid)
    from titan_tpu_torch.olap import snapshot as SN
    from titan_tpu_torch.olap.rmat import rmat_edges

    src_e, dst_e = rmat_edges(scale, 16, seed=2)
    snap = SN.from_arrays(1 << scale, np.concatenate([src_e, dst_e]),
                          np.concatenate([dst_e, src_e]))
    dst_by_src, indptr = snap.out_csr()
    deg = np.asarray(snap.out_degree)
    dstT, colstart, _, q_total = chunked_layout(dst_by_src, indptr,
                                                deg.astype(np.int64), snap.n)
    hg = {"n": snap.n, "q_total": q_total, "deg": deg,
          "colstart": colstart, "dstT": dstT}
    source = int(np.argmax(deg))
    dist_, levels = run_multihost_bfs(hg, source, mesh)
    if mesh.rank != 0:
        return {}
    ref, _ = frontier_bfs_hybrid(snap, source, device=mesh.device)
    bu_levels = [p for p in S.LAST_PROFILE if p["mode"] == "bu"]
    return {"processes": mesh.world, "devices": mesh.world,
            "local_devices": 1, "scale": scale, "levels": levels,
            "reached": int((dist_ < (1 << 30)).sum()),
            "bit_equal_vs_single_chip": bool(np.array_equal(dist_, ref)),
            "bu_levels_fused": len(bu_levels),
            "dispatches_per_level_max": max(
                (p["dispatches"] for p in S.LAST_PROFILE), default=0),
            "bu_trails": [p["bu_trail"] for p in bu_levels]}


def main(argv=None) -> int:
    """``python -m titan_tpu_torch.parallel.multihost [--world 2]
    [--scale 13] [--device cuda] [--backend nccl|gloo]``: the dry run.
    Exits 0 with the ``MULTIHOST_OK`` line, 2 when rank 0's ``dist``
    differs from the single-card BFS."""
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="titan_tpu_torch.parallel.multihost")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--scale", type=int, default=13)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    a = ap.parse_args(argv)
    # by the module's own name, so the spawned ranks can import it
    from titan_tpu_torch.parallel import multihost
    rec = launch(multihost._worker, a.world, a.device, a.backend,
                 (a.scale,))
    print("MULTIHOST_OK " + json.dumps(rec), flush=True)
    return 0 if rec["bit_equal_vs_single_chip"] else 2


if __name__ == "__main__":
    import sys

    sys.exit(main())
