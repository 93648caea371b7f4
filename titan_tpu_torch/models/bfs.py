"""Breadth-first search (unweighted hop count): the engine's
DenseProgram and the push-frontier BFS (port of
``titan_tpu/models/bfs.py``).

The DenseProgram (``BFS``, ``run``): pull-mode supersteps,
dist' = min(dist, min over in-edges of dist[src] + 1), until no distance
changes.

The push-frontier BFS (``frontier_bfs``, ``frontier_bfs_tiled``): each
level expands only the frontier's out-edges over the out-CSR, so a whole
run does O(E) index work instead of O(E x diameter). Plain PyTorch, as
in the JAX package, where XLA computes it outside any Pallas kernel. The
JAX semantics kept by hand:

* ``dist`` has ``n + 1`` slots; dead lanes scatter into the sink row
  ``n`` (a min-scatter, so duplicates do not depend on order), which
  the level's frontier never counts;
* the delta-scatter + cumsum expansion drops, never clamps, a segment
  start at or past ``m_cap`` (``_expand_neighbors``);
* ``jnp.nonzero(size=, fill_value=)`` is ``ops.compaction.compact_ids``:
  ascending ids, the fill past the count;
* counts and prefix sums are int32, as with JAX's x64 off; the callers
  keep every edge total below 2^31 (``frontier_bfs`` refuses 2^31 edges
  or more; ``frontier_bfs_tiled`` cuts the out-CSR into vertex-range
  shards of fewer edges each).

``dist`` is updated in place (JAX donates it). The device copies of the
out-CSR are cached on the snapshot by device under the port's own names,
``_frontier_csr_by_device``, ``_tiled_shards_by_device`` and
``_out_degree_by_device`` (never JAX's ``_dev_frontier``,
``_tiled_shards`` and ``_dev_outdeg``: one snapshot may be handed to
both packages); ``GraphSnapshot.refresh()`` drops them.

``frontier_bfs_sharded`` (the shard_map level step over a mesh) belongs
to the multi-device slice, ROADMAP queue 1 item 9, and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from titan_tpu_torch.device import INF, cache_key, next_pow2, resolve_device
from titan_tpu_torch.errors import not_ported
from titan_tpu_torch.olap.api import DenseProgram
from titan_tpu_torch.ops.compaction import compact_ids


class BFS(DenseProgram):
    combine = "min"

    def __init__(self, max_iterations: int = 1000):
        self.max_iterations = max_iterations

    def init(self, n, params):
        dist = torch.full((n,), INF, dtype=torch.int32)
        dist[int(params["source_dense"])] = 0
        return {"dist": dist}

    def message(self, src_state, edge_data, params):
        d = src_state["dist"]
        return torch.where(d >= INF, INF, d + 1)

    def apply(self, state, agg, iteration, params):
        return {"dist": torch.minimum(state["dist"], agg)}

    def done(self, state, new_state, agg, iteration, params):
        return torch.equal(new_state["dist"], state["dist"])

    def outputs(self, state, params):
        return {"dist": state["dist"]}


def run(computer, source, snapshot=None, max_iterations: int = 1000):
    """``source``: original vertex id (graph mode) or dense index
    (snapshot mode)."""
    snap = snapshot or computer.snapshot()
    dense = snap.dense_of(source) if in_snapshot_ids(snap, source) \
        else int(source)
    prog = BFS(max_iterations)
    return computer.run(prog, params={"source_dense": dense}, snapshot=snap)


def in_snapshot_ids(snap, source) -> bool:
    i = np.searchsorted(snap.vertex_ids, source)
    return i < snap.n and snap.vertex_ids[i] == source


# ---------------------------------------------------------------------------
# frontier-sparse BFS (single device)
# ---------------------------------------------------------------------------

def _expand_neighbors(mask, degs, indptr_vals, dst_arr, m_cap: int, n_: int):
    """The frontier expansion: a delta-scatter + cumsum, so each edge
    costs one gather here and one scatter at the caller.

    ``mask``: the frontier slots to expand; ``degs``: their out-degrees;
    ``indptr_vals``: each slot's first edge in ``dst_arr``. Returns
    ``[m_cap]`` int32 neighbour ids, ``n_`` on dead lanes."""
    dev = mask.device
    degs = torch.where(mask, degs, 0).to(torch.int32)
    offsets = torch.cumsum(degs, 0, dtype=torch.int32)           # inclusive
    starts = offsets - degs                                      # exclusive
    m_total = offsets[-1]
    # base2[i] = indptr_vals[i] - starts[i]: at edge j of slot i the edge
    # index is base2[i] + j; consecutive deltas scattered at the segment
    # starts and summed propagate it (the colliding starts of empty slots
    # sum their deltas, and the net is still right)
    base2 = torch.where(mask, indptr_vals, 0).to(torch.int32) - starts
    delta = torch.diff(base2, prepend=base2.new_zeros(1))
    # drop (not clamp) starts at or past m_cap: a clamped delta would
    # land on the last live lane and corrupt its edge index
    acc = torch.zeros(m_cap + 1, dtype=torch.int32, device=dev)
    acc.index_add_(0, torch.where(starts < m_cap, starts, m_cap).long(),
                   delta)
    j = torch.arange(m_cap, dtype=torch.int32, device=dev)
    edge_idx = torch.cumsum(acc[:m_cap], 0, dtype=torch.int32) + j
    nbr = dst_arr[edge_idx.clamp(0, dst_arr.shape[0] - 1).long()]
    return torch.where(j < m_total, nbr, n_).to(torch.int32)


def _level_step(dist, frontier, f_count: int, level: int, dev_csr,
                f_cap: int, m_cap: int, n_: int):
    """One level: expand the first ``f_count`` of ``frontier`` [f_cap],
    min-scatter ``level + 1`` (dead lanes into the sink row ``n_``), and
    return ``(next_frontier [n_], nf, m_next)`` with the counts one
    0-d int32 tensor each."""
    dev = dist.device
    out_degree = dev_csr["out_degree"]
    valid = torch.arange(f_cap, device=dev) < f_count
    fvert = frontier.clamp(max=n_ - 1).long()
    nbr = _expand_neighbors(valid, out_degree[fvert],
                            dev_csr["indptr_out"][fvert],
                            dev_csr["dst_by_src"], m_cap, n_)
    dist.scatter_reduce_(0, nbr.long(), torch.full_like(nbr, level + 1),
                         reduce="amin")
    changed = dist[:n_] == level + 1
    nf = changed.sum(dtype=torch.int32)
    # the next level's edge total, so the host reads back once a level
    m_next = torch.where(changed, out_degree, 0).sum(dtype=torch.int32)
    _, nxt = compact_ids(changed, n_, n_)
    return nxt, nf, m_next


def _device_frontier_csr(snap, dev) -> dict:
    """The out-CSR on ``dev``, cached as ``snap._frontier_csr_by_device``."""
    key = cache_key(dev)
    cache = getattr(snap, "_frontier_csr_by_device", None)
    if cache is not None and key in cache:
        return cache[key]
    dst_by_src, indptr_out = snap.out_csr()
    out = {"dst_by_src": torch.from_numpy(
               np.ascontiguousarray(dst_by_src, np.int32)).to(key),
           "indptr_out": torch.from_numpy(
               indptr_out.astype(np.int32)).to(key),
           "out_degree": torch.from_numpy(
               np.asarray(snap.out_degree).astype(np.int32)).to(key)}
    if cache is None:
        cache = {}
        snap._frontier_csr_by_device = cache
    cache[key] = out
    return out


def frontier_bfs(snap, source_dense: int, max_levels: int = 1000,
                 device=None):
    """Host-driven frontier BFS: each level expands only the frontier's
    out-edges. The frontier and its edge total are padded to power-of-two
    capacity buckets, as in the JAX package, and the host reads the two
    counts back once a level.

    Returns ``(dist ndarray [n] int32 with INF for unreachable,
    levels)``."""
    dev = resolve_device(device)
    n = snap.n
    e_total = int(snap.num_edges)
    if e_total >= (1 << 31):
        raise NotImplementedError(
            "frontier_bfs uses int32 edge indices (x64 is off); shard the "
            "snapshot below 2^31 edges per chip")
    csr = _device_frontier_csr(snap, dev)
    dist = torch.full((n + 1,), INF, dtype=torch.int32, device=dev)
    dist[source_dense] = 0
    frontier = torch.full((n,), n, dtype=torch.int32, device=dev)
    frontier[0] = source_dense
    f_count = 1
    m_total = int(snap.out_degree[source_dense])
    level = 0
    while f_count > 0 and m_total > 0 and level < max_levels:
        f_cap = min(next_pow2(f_count), n)
        m_cap = min(next_pow2(m_total), max(next_pow2(e_total), 2))
        frontier, nf, m_next = _level_step(
            dist, frontier[:f_cap], f_count, level, csr, f_cap, m_cap, n)
        f_count, m_total = torch.stack([nf, m_next]).tolist()
        level += 1
    return dist[:n].cpu().numpy(), level


def frontier_bfs_sharded(snap, source_dense: int, mesh,
                         max_levels: int = 1000):
    """The JAX package's shard_map frontier BFS over a mesh: the
    multi-device slice, not ported."""
    raise not_ported("frontier_bfs_sharded", item=9)


# ---------------------------------------------------------------------------
# tiled frontier BFS: fixed-shape slices, device-side planning
# ---------------------------------------------------------------------------
#
# Every level goes as a sequence of slices of at most f_tile frontier
# slots and m_tile edge slots, planned on the device after the level
# before; slices never cross a vertex-range shard's bounds, so each
# shard's LOCAL edge indices stay below 2^31, which is what lets Graph500
# scale 26 (2^31 directed edges) run with int32 indices.


def _tile_step(dist, frontier, fb: int, fcnt: int, level: int, base: int,
               dst_l, ip_l, deg_l, f_tile: int, m_tile: int, n_: int,
               block: int) -> None:
    """One slice: ``frontier[fb : fb + fcnt]``, all inside the shard whose
    vertex block starts at ``base``, expanded into ``dist`` in place."""
    dev = dist.device
    fvert = frontier[fb:fb + f_tile]
    valid = torch.arange(f_tile, device=dev) < fcnt
    local = (fvert - base).clamp(0, block - 1).long()
    degs = torch.where(valid, deg_l[local], 0)
    nbr = _expand_neighbors(valid, degs, ip_l[local], dst_l, m_tile, n_)
    dist.scatter_reduce_(0, nbr.long(), torch.full_like(nbr, level + 1),
                         reduce="amin")


def _tile_wrapup(dist, level: int, out_degree, f_tile: int, budget: int,
                 k_max: int, n_: int, shard_bounds: tuple):
    """After all of level ``level``'s slices: the next frontier and its
    slice plan. Returns ``(frontier [n_ + f_tile] int32, plan [S, 2,
    k_max + 1] int32, stats [1 + S] int32)``: plan row 0 holds frontier-
    index bounds (slice k of shard d is ``frontier[plan[d, 0, k] :
    plan[d, 0, k + 1]]``; it stops advancing after the last), row 1 the
    edge prefix at each bound; stats are the frontier's size and each
    shard's edge total."""
    dev = dist.device
    changed = dist[:n_] == level + 1
    nf = changed.sum(dtype=torch.int32)
    _, frontier = compact_ids(changed, n_ + f_tile, n_)
    fdeg = torch.where(changed, out_degree, 0)
    # the global frontier-index prefix: fcp[v] = frontier vertices <= v
    fcp = torch.cumsum(changed, 0, dtype=torch.int32)
    ids = torch.arange(n_, device=dev)
    plans, stats = [], [nf]
    for d in range(len(shard_bounds) - 1):
        lo, hi = shard_bounds[d], shard_bounds[d + 1]
        inside = (ids >= lo) & (ids < hi)
        cumd = torch.cumsum(torch.where(inside, fdeg, 0), 0,
                            dtype=torch.int32)
        stats.append(cumd[n_ - 1])
        plan = torch.zeros((2, k_max + 1), dtype=torch.int32, device=dev)
        if lo > 0:
            plan[0, 0] = fcp[lo - 1]
        v = torch.tensor(lo, dtype=torch.int64, device=dev)
        for k in range(k_max):
            back = (v - 1).clamp(min=0)
            prev_e = torch.where(v > 0, cumd[back], 0).to(torch.int64)
            prev_f = torch.where(v > 0, fcp[back], 0).to(torch.int64)
            nv = torch.searchsorted(cumd, (prev_e + budget).to(torch.int32),
                                    right=True)
            nv2 = torch.searchsorted(fcp, (prev_f + f_tile).to(torch.int32),
                                     right=True)
            v = torch.minimum(torch.minimum(nv, nv2),
                              torch.tensor(hi, device=dev))
            back = (v - 1).clamp(min=0)
            plan[0, k + 1] = torch.where(v > 0, fcp[back], 0)
            plan[1, k + 1] = torch.where(v > 0, cumd[back], 0)
        plans.append(plan)
    return frontier, torch.stack(plans), torch.stack(stats)


def _shard_out_csr_balanced(snap, max_edges: int, device=None):
    """Vertex-range shards with about edge-balanced cuts (each shard's
    edges <= max(max_edges, the heaviest vertex)), padded to one shape.
    Returns ``(shard_bounds, block, e_max, [(base, dst, ip, deg)])``,
    the arrays on ``device``; cached as
    ``snap._tiled_shards_by_device[device] = (max_edges, result)``."""
    key = cache_key(device)
    cache = getattr(snap, "_tiled_shards_by_device", None)
    if cache is not None and key in cache and cache[key][0] == max_edges:
        return cache[key][1]
    n = snap.n
    dst_by_src, indptr_out = snap.out_csr()
    e_total = int(indptr_out[-1])
    num = max(1, -(-e_total // max_edges))
    # cut where the edge prefix crosses k/num of the total
    cuts = [0]
    for k in range(1, num):
        cuts.append(int(np.searchsorted(indptr_out, k * e_total / num)))
    cuts.append(n)
    bounds = tuple(sorted(set(cuts)))
    num = len(bounds) - 1
    block = max(1, max(bounds[d + 1] - bounds[d] for d in range(num)))
    e_max = max(1, max(int(indptr_out[bounds[d + 1]] - indptr_out[bounds[d]])
                       for d in range(num)))
    shards = []
    for d in range(num):
        lo_v, hi_v = bounds[d], bounds[d + 1]
        s, e = int(indptr_out[lo_v]), int(indptr_out[hi_v])
        dst_l = np.full((e_max,), n, np.int32)
        dst_l[:e - s] = dst_by_src[s:e]
        ip_l = np.zeros((block + 1,), np.int32)
        ip = (indptr_out[lo_v:hi_v + 1] - s).astype(np.int32)
        ip_l[:hi_v - lo_v + 1] = ip
        ip_l[hi_v - lo_v + 1:] = ip[-1] if len(ip) else 0
        deg_l = np.zeros((block,), np.int32)
        deg_l[:hi_v - lo_v] = snap.out_degree[lo_v:hi_v]
        shards.append((lo_v, torch.from_numpy(dst_l).to(key),
                       torch.from_numpy(ip_l).to(key),
                       torch.from_numpy(deg_l).to(key)))
    got = (bounds, block, e_max, shards)
    if cache is None:
        cache = {}
        snap._tiled_shards_by_device = cache
    cache[key] = (max_edges, got)
    return got


def _device_out_degree(snap, dev):
    """int32 out-degrees on ``dev``, cached as
    ``snap._out_degree_by_device``."""
    key = cache_key(dev)
    cache = getattr(snap, "_out_degree_by_device", None)
    if cache is None:
        cache = {}
        snap._out_degree_by_device = cache
    if key not in cache:
        cache[key] = torch.from_numpy(
            np.asarray(snap.out_degree).astype(np.int32)).to(key)
    return cache[key]


def tile_sizes(f_tile: int, m_tile: int) -> tuple[list, list]:
    """The short ladders a slice's ``(f, m)`` sizes come from: a light
    level need not pay the full tile's shapes."""
    f_sizes = sorted({min(1 << 14, f_tile), min(1 << 18, f_tile), f_tile})
    m_sizes = sorted({min(1 << s, m_tile) for s in (18, 21, 24, 27)}
                     | {m_tile})
    return f_sizes, m_sizes


def _pick(sizes, need):
    for s in sizes:
        if need <= s:
            return s
    return sizes[-1]


def tile_params(snap, f_tile: int, m_tile: int, max_shard_edges: int,
                k_max: int, device=None) -> dict:
    """The tiled BFS's shapes for ``snap``, as ``frontier_bfs_tiled``
    derives them: the shards, ``m_tile`` floored at twice the largest
    degree, the planning ``budget``, ``f_tile`` and ``k_max``."""
    n = snap.n
    bounds, block, e_max, shards = _shard_out_csr_balanced(
        snap, max_shard_edges, device)
    max_deg = int(np.asarray(snap.out_degree).max()) if n else 0
    # budget >= max_deg guarantees every slice advances by >= 1 vertex (a
    # vertex heavier than the budget would otherwise plan empty slices
    # forever and silently drop the frontier's tail)
    m_tile = max(m_tile, 2 * max_deg)
    m_tile = min(m_tile, max(2 * max_deg, next_pow2(e_max), 2))
    budget = max(1, m_tile - max_deg)
    f_tile = min(f_tile, next_pow2(n))
    # enough slice slots that no level outgrows the plan: a shard's level
    # needs at most ceil(edges/budget) + ceil(frontier/f_tile) slices,
    # plus one spare that must stay idle (the truncation check needs it)
    k_max = max(k_max, -(-e_max // budget) + -(-block // f_tile) + 2)
    return {"bounds": bounds, "block": block, "e_max": e_max,
            "shards": shards, "m_tile": m_tile, "budget": budget,
            "f_tile": f_tile, "k_max": k_max}


def frontier_bfs_tiled(snap, source_dense: int, max_levels: int = 1000,
                       f_tile: int = 1 << 21, m_tile: int = 1 << 27,
                       max_shard_edges: int = 1 << 30, k_max: int = 96,
                       device=None):
    """Frontier BFS in fixed-shape slices (see the comment above). Works
    at any scale whose per-shard edge count fits int32, Graph500 scale 26
    through 2 or more shards.

    Returns ``(dist ndarray [n] int32 with INF for unreachable,
    levels)``."""
    dev = resolve_device(device)
    n = snap.n
    t = tile_params(snap, f_tile, m_tile, max_shard_edges, k_max, dev)
    f_tile, m_tile, k_max = t["f_tile"], t["m_tile"], t["k_max"]
    budget, bounds, block = t["budget"], t["bounds"], t["block"]
    outdeg = _device_out_degree(snap, dev)
    dist = torch.full((n + 1,), INF, dtype=torch.int32, device=dev)
    dist[source_dense] = 0
    # the source's "level -1 wrapup" plans level 0's slices
    frontier, plan, stats = _tile_wrapup(dist, -1, outdeg, f_tile, budget,
                                         k_max, n, bounds)
    f_sizes, m_sizes = tile_sizes(f_tile, m_tile)
    level = 0
    while level < max_levels:
        plan_h = plan.cpu().numpy()
        stats_h = stats.cpu().numpy()
        nf = int(stats_h[0])
        m_total = sum(int(x) for x in stats_h[1:])
        if nf == 0 or m_total == 0:
            break
        for d, (base, dst_l, ip_l, deg_l) in enumerate(t["shards"]):
            frow, erow = plan_h[d]
            if frow[k_max] > frow[k_max - 1]:
                raise RuntimeError(
                    f"slice plan truncated at k_max={k_max} (shard {d}) — "
                    f"frontier tail would be silently dropped")
            for k in range(k_max):
                fb, fe = int(frow[k]), int(frow[k + 1])
                if fe <= fb:
                    break
                m_slice = int(erow[k + 1]) - int(erow[k])
                _tile_step(dist, frontier, fb, fe - fb, level, base, dst_l,
                           ip_l, deg_l, _pick(f_sizes, fe - fb),
                           _pick(m_sizes, max(m_slice, 1)), n, block)
        frontier, plan, stats = _tile_wrapup(dist, level, outdeg, f_tile,
                                             budget, k_max, n, bounds)
        level += 1
    return dist[:n].cpu().numpy(), level
