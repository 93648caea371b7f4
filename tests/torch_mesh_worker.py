"""The ranks' side of the port's multi-device tests: module-level
functions that ``titan_tpu_torch.parallel.multihost.launch`` runs in
spawned ranks over gloo on the CPU, one launch a world size and test
file. Inputs and outputs are numpy; each function checks that every rank
computed the same replicated result, and that its rank loaded nothing of
jax or titan_tpu. Nothing here imports either."""

from __future__ import annotations

import sys

import numpy as np
import torch


def _setup() -> None:
    torch.set_num_threads(1)


def _no_jax() -> None:
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "titan_tpu"))
    assert not bad, bad


def _same_on_every_rank(mesh, a) -> None:
    t = torch.as_tensor(np.ascontiguousarray(a))
    got = mesh.all_gather(t)
    assert all(torch.equal(got[0], got[r]) for r in range(mesh.world))


def _gathered(mesh, t: torch.Tensor) -> np.ndarray:
    """Every rank's ``t`` (same shape on each), ``[world, ...]`` numpy."""
    return mesh.all_gather(t).cpu().numpy()


def _snapshot(case: dict):
    from titan_tpu_torch.olap import snapshot as SN
    return SN.from_arrays(case["n"], case["src"], case["dst"],
                          edge_values=case.get("edge_values"))


def sharded_bfs_cases(mesh, cases: list) -> list:
    """``frontier_bfs_hybrid_sharded`` on each case (``n``, ``src``,
    ``dst``: a symmetric edge list, ``source``): ``dist``, ``levels``,
    ``LAST_EXCHANGE_CAPS`` and ``LAST_PROFILE``."""
    from titan_tpu_torch.models import bfs_hybrid_sharded as S

    _setup()
    out = []
    for case in cases:
        dist, levels = S.frontier_bfs_hybrid_sharded(
            _snapshot(case), case["source"], mesh)
        _same_on_every_rank(mesh, dist)
        out.append({"dist": dist, "levels": levels,
                    "caps": list(S.LAST_EXCHANGE_CAPS),
                    "profile": [dict(p) for p in S.LAST_PROFILE]})
    _no_jax()
    return out


def push_bfs_cases(mesh, cases: list) -> list:
    """``models/bfs.frontier_bfs_sharded`` on each case (a directed edge
    list): ``(dist, levels)``."""
    from titan_tpu_torch.models import bfs as PB

    _setup()
    out = []
    for case in cases:
        dist, levels = PB.frontier_bfs_sharded(_snapshot(case),
                                               case["source"], mesh)
        _same_on_every_rank(mesh, dist)
        out.append((dist, levels))
    _no_jax()
    return out


def partition_cases(mesh, cases: list) -> list:
    """Each rank's device blocks, gathered to rank 0: the sharded BFS's
    (``rank_shard``: dstT, LOCAL colstart, degc, window) and the
    engine's (``olap/engine.sharded_block``), and ``exchange_found`` of
    the rank's row of ``case["masks"]`` [world, n] at ``found_cap``."""
    from titan_tpu_torch.models import bfs_hybrid_sharded as S
    from titan_tpu_torch.olap import engine as E
    from titan_tpu_torch.parallel.partition import exchange_found

    _setup()
    out = []
    for case in cases:
        snap = _snapshot(case)
        sh = S.rank_shard(snap, mesh)
        blk = E.sharded_block(snap, mesh)
        mask = torch.from_numpy(case["masks"][mesh.rank])
        ids, found_max = exchange_found(mask, case["found_cap"], snap.n,
                                        mesh)
        _same_on_every_rank(mesh, ids.numpy())
        window = torch.tensor([sh["lo"], sh["hi"]])
        out.append({
            "dstT": _gathered(mesh, sh["dstT"]),
            "colstart": _gathered(mesh, sh["colstart"]),
            "degc": _gathered(mesh, sh["degc_l"]),
            "window": _gathered(mesh, window),
            "describe": sh["layout"].describe(),
            "src_global": _gathered(mesh, blk.src),
            "dst_local": _gathered(mesh, blk.dst),
            "valid": _gathered(mesh, blk.valid),
            "last_idx": _gathered(mesh, blk.last_idx),
            "seg_has": _gathered(mesh, blk.seg_has),
            "ids": ids.numpy(), "found_max": int(found_max)})
    _no_jax()
    return out


def _program(case: dict):
    """The program, its params and its snapshot for an engine case."""
    from titan_tpu_torch.models import bfs, hits, kcore, pagerank

    kind, snap = case["kind"], _snapshot(case)
    if kind == "bfs":
        return bfs.BFS(), {"source_dense": case["source"]}, snap
    if kind == "kcore":
        return kcore.KCore(case["k"]), {}, snap
    if kind == "hits":
        return hits.HITS(iterations=case["iterations"]), {}, snap
    inv = np.where(snap.out_degree > 0,
                   1.0 / np.maximum(snap.out_degree, 1),
                   0.0).astype(np.float32)
    return (pagerank.PageRank(iterations=case["iterations"]),
            {"n": snap.n, "inv_outdeg": inv}, snap)


def engine_cases(mesh, cases: list, ckpt_dir: str) -> dict:
    """Each case through ``GPUGraphComputer(num_devices=world)`` (with
    ``TopRanksMapReduce`` for ``"top_ranks"``), through ``num_devices=0``
    under the group, and through ``run_sharded`` on the mesh directly;
    then a checkpointed run into ``ckpt_dir`` (refused unless the world
    is 1). Returns the outputs, iteration counts and MapReduce memory of
    each, and the refusal's message."""
    from titan_tpu_torch.models import bfs as MB
    from titan_tpu_torch.models.pagerank import TopRanksMapReduce
    from titan_tpu_torch.olap import engine as E

    _setup()
    out = {"cases": []}
    for case in cases:
        prog, params, snap = _program(case)
        mrs = [TopRanksMapReduce(k=5)] if case.get("top_ranks") else None
        runs = {}
        for name, ndev in (("computer", mesh.world), ("computer0", 0)):
            comp = E.GPUGraphComputer(snapshot=snap, device=mesh.device,
                                      num_devices=ndev)
            r = comp.run(prog, params=params, snapshot=snap,
                         map_reduces=mrs)
            runs[name] = (dict(r), r.iterations, dict(r.memory))
        r = E.run_sharded(prog, snap, params, mesh)
        runs["run_sharded"] = (dict(r), r.iterations, {})
        for name, (arrays, _, _) in runs.items():
            for v in arrays.values():
                _same_on_every_rank(mesh, v)
        out["cases"].append(runs)
    snap = _snapshot(cases[0])
    comp = E.GPUGraphComputer(snapshot=snap, device=mesh.device,
                              num_devices=mesh.world)
    try:
        comp.run(MB.BFS(), {"source_dense": 0},
                 checkpoint_to=f"{ckpt_dir}/rank{mesh.rank}",
                 checkpoint_every=1)
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    _no_jax()
    return out


def fail_on_rank_1(mesh):
    """Rank 1 raises while rank 0 waits in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    return mesh.all_reduce(torch.ones(1), "sum")
