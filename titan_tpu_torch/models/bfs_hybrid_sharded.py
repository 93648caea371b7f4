"""Direction-optimizing BFS over a vertex-block mesh (port of
``titan_tpu/models/bfs_hybrid_sharded.py``).

Each rank holds only its vertex block's 8-aligned chunked out-CSR (local
column indices, cut edge-balanced on the chunk prefix) and a replicated
``dist``. A level runs on every rank's block, then the ranks exchange
only their newly-found vertex ids (``parallel/partition.exchange_found``:
O(frontier) communication), merge them into ``dist`` and compute the
stats vector ``[f_count, m8_f, m8_unvis, found_max, m8f_chip,
nunv_chip]``, whose per-rank maxima size the next level's caps. The host
loop reads the stats back once a level and takes the JAX package's
decisions from them: ``use_bu = m8_f * ALPHA > m8_unvis and f_count >
1``, the exchange cap first guessed from the source's degree, then ``4 *
found_max``; a level whose exchange overflowed its cap exchanges again
with the exact cap (``retries``). ``dist`` is ``[n+2]`` on every rank as
in the single-card hybrid (``n+1`` absorbs the pad scatters), INF for
unreached; the result is its first ``n``.

Where the port differs from the JAX package, and why:

* **Top-down level**: the frontier list from the replicated ``dist``, the
  rank's owned share expanded through its block (as JAX).
* **Bottom-up level**: the rank's candidates (unvisited block vertices
  with chunks) go through the single-card hybrid's rounds: an opener and
  the chunk rounds, each one ``ops/frontier.frontier_round`` launch
  (the ``pallas`` branch of JAX's ``shx_bu``), then the exhaustive sweep
  of the single-card port for the stragglers. JAX's ``lax.cond``
  survivor-width ladder exists because XLA needs static shapes; its
  widths only pad, so the port sizes each pass by the survivors it
  reads back, as the single-card hybrid does. JAX's K-chunk-stride
  ``while_loop`` is replaced by that sweep; the set found is the same
  (every unvisited block vertex with a parent in the frontier).
* **Retries**: JAX re-runs the whole level with the exact cap; the port
  keeps the level's own discoveries (a mask computed once) and repeats
  only the exchange, merging the full id lists into a ``dist`` that may
  already hold a truncated subset of them (setting ``level + 1`` twice
  changes nothing). The result and the stats equal JAX's.
* **Readbacks**: one stats readback a level plus one a retry (JAX's
  ``dispatches``); a bottom-up level also reads back its survivor counts
  after the opener and after the rounds, as the single-card hybrid does.
* **Multiple processes** need no power-of-two vertex count: JAX refuses
  one because its frontier pad would mix global and process-local
  arrays, and the port has no global arrays.

``LAST_EXCHANGE_CAPS`` and ``LAST_PROFILE`` record the most recent run
(on every rank) field for field as JAX's do. The rank's device block is
cached by ``mesh.key`` (device, world, rank): on a snapshot as
``snap._hybrid_shards_by_mesh``, on a host graph dict under the key
``"_hybrid_shards_by_mesh"`` (never JAX's ``_shards``); dropping the
entry frees the block. Symmetric graphs only.
"""

from __future__ import annotations

import numpy as np
import torch

from titan_tpu_torch.device import INF, next_pow2
from titan_tpu_torch.models.bfs_hybrid import (SPLIT_LANES, _bit_of,
                                               _found_per, _pack_bits,
                                               _set_level, chunked_layout,
                                               enumerate_chunk_pairs)
from titan_tpu_torch.ops.compaction import compact_ids
from titan_tpu_torch.ops.frontier import frontier_round
from titan_tpu_torch.parallel.mesh import VertexMesh
from titan_tpu_torch.parallel.multihost import host_replicated, host_sharded
from titan_tpu_torch.parallel.partition import block_layout, exchange_found

ALPHA = 8.0
BU_CHUNK_ROUNDS = 8

# the stats vector's layout
ST_NF, ST_M8F, ST_M8UNVIS, ST_FOUNDMAX, ST_M8F_CHIP, ST_NUNV_CHIP = range(6)

#: found_cap used by each level's exchange in the most recent run
LAST_EXCHANGE_CAPS: list = []
#: per level of the most recent run: mode, frontier size, per-chip found
#: max, exchange cap and volume, retries and dispatches, as JAX's
LAST_PROFILE: list = []

#: where a graph dict keeps its ranks' device blocks
_CACHE = "_hybrid_shards_by_mesh"


def plan_shard_cuts(colstart: np.ndarray, n: int, num_shards: int,
                    align: int = 1):
    """Edge-balanced vertex-range cuts on the chunk prefix, with the int32
    guard: per-shard arrays use LOCAL column indices, so every shard's
    chunk span must stay below 2^31 even when the global chunk count
    exceeds it (``colstart`` is int64). ``align`` rounds each inner cut
    to the nearest multiple of it (the mesh-placed batched BFS cuts on
    multiples of 8 vertices; 1, the JAX package's cuts, leaves them).
    Returns ``(bounds [d_eff+1] int64, b_max, q_max)``; raises
    NotImplementedError when a shard's local span would overflow
    int32."""
    total = int(colstart[n])
    cuts = [0]
    for k in range(1, num_shards):
        c = int(np.searchsorted(colstart[:n + 1], k * total / num_shards))
        cuts.append(min((c + align // 2) // align * align, n))
    cuts.append(n)
    bounds = np.asarray(sorted(set(cuts)), np.int64)
    d_eff = len(bounds) - 1
    b_max = max(1, int((bounds[1:] - bounds[:-1]).max()))
    spans = [int(colstart[bounds[d + 1]] - colstart[bounds[d]])
             for d in range(d_eff)]
    q_max = max(1, max(spans)) + 1       # +1 local sink col
    if q_max >= (1 << 31):
        raise NotImplementedError(
            f"a shard's local chunk span ({max(spans)}) exceeds int32; "
            f"use more shards than {num_shards} (local column indices "
            "are int32)")
    return bounds, b_max, q_max


def shard_unvisited_cap(degc_all: np.ndarray, bounds) -> int:
    """Max over shards of the count of expandable (degc > 0) block
    vertices: the first bottom-up level's candidate cap."""
    counts = [int((degc_all[int(bounds[d]):int(bounds[d + 1])] > 0).sum())
              for d in range(len(bounds) - 1)]
    return max(counts, default=1) or 1


def pack_shard_block(d: int, colstart: np.ndarray, dstT: np.ndarray,
                     degc_all: np.ndarray, bounds: np.ndarray,
                     b_max: int, q_max: int, n: int):
    """Pack vertex block ``d`` into the padded per-shard layout: (dstT [8,
    q_max] pad n+1, LOCAL colstart [b_max+1] with the tail held at the
    last live value, degc [b_max]). The one definition of the block."""
    dstT_b = np.full((8, q_max), n + 1, np.int32)
    cs_b = np.zeros(b_max + 1, np.int32)
    degc_b = np.zeros(b_max, np.int32)
    if d < len(bounds) - 1 and bounds[d] < bounds[d + 1]:
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        c0, c1 = int(colstart[lo]), int(colstart[hi])
        dstT_b[:, :c1 - c0] = dstT[:, c0:c1]
        local = (colstart[lo:hi + 1] - c0).astype(np.int32)
        cs_b[:hi - lo + 1] = local
        cs_b[hi - lo + 1:] = local[-1]
        degc_b[:hi - lo] = degc_all[lo:hi]
    return dstT_b, cs_b, degc_b


def shard_chunked_csr(snap_or_graph, num_shards: int) -> dict:
    """The host side of a D-way sharding: the chunked layout's host
    arrays (``dstT``, int64 ``colstart``, ``degc_all``), the
    ``BlockLayout`` and what the BFS loop reads from it (``bounds``,
    ``b_max``, ``q_max``, ``degc`` [n+1] int32, ``total_chunks``,
    ``shard_chunks``, ``nunv_chip_max``). ``snap_or_graph`` is a snapshot
    (its out-CSR laid out here) or a host graph dict (``n``,
    ``q_total``, ``dstT``, ``colstart``, and ``deg`` or ``degc``: the
    ``graph500.load_or_build`` dict, memory-mapped arrays included).
    Blocks are packed by the ranks (``pack_shard_block``)."""
    if isinstance(snap_or_graph, dict):
        g = snap_or_graph
        for k in ("colstart", "dstT"):
            if not isinstance(g[k], np.ndarray):       # np.memmap passes
                raise TypeError(
                    "shard_chunked_csr needs host (numpy) graph arrays; "
                    "pass the graph500.load_or_build dict or a snapshot, "
                    "not a device graph dict")
        n, q_total, dstT = g["n"], g["q_total"], g["dstT"]
        colstart = np.asarray(g["colstart"]).astype(np.int64)
        if "degc" in g:
            degc_all = np.asarray(g["degc"])[:n].astype(np.int32)
        else:
            degc_all = (-(-np.asarray(g["deg"])[:n] // 8)).astype(np.int32)
    else:
        snap = snap_or_graph
        n = snap.n
        dst_by_src, indptr = snap.out_csr()
        dstT, colstart, degc, q_total = chunked_layout(
            dst_by_src, indptr, np.asarray(snap.out_degree, np.int64), n)
        degc_all = degc.astype(np.int32)
    layout = block_layout(colstart, degc_all, n, num_shards)
    return {"dstT": dstT, "colstart": colstart, "degc_all": degc_all,
            "bounds": np.asarray(layout.bounds, np.int64), "n": n,
            "b_max": layout.b_max, "q_max": layout.q_max,
            "q_total": q_total,
            "degc": np.concatenate([degc_all, [0]]).astype(np.int32),
            "total_chunks": int(colstart[n]), "layout": layout,
            "shard_chunks": list(layout.shard_chunks),
            "nunv_chip_max": layout.nunv_cap}


def _caches(snap_or_graph) -> dict:
    if isinstance(snap_or_graph, dict):
        return snap_or_graph.setdefault(_CACHE, {})
    cache = getattr(snap_or_graph, _CACHE, None)
    if cache is None:
        cache = {}
        setattr(snap_or_graph, _CACHE, cache)
    return cache


def rank_shard(snap_or_graph, mesh: VertexMesh) -> dict:
    """This rank's block on its device, packed and uploaded once and
    cached by ``mesh.key``: ``dstT`` [8, q_max], LOCAL ``colstart``
    [b_max+1] and ``degc`` [b_max] of the block, the replicated
    ``degc_all`` [n+1], the window ``lo``/``hi``, and the host scalars of
    ``shard_chunked_csr`` (``degc`` as a host array)."""
    cache = _caches(snap_or_graph)
    got = cache.get(mesh.key)
    if got is not None:
        return got
    sh = shard_chunked_csr(snap_or_graph, mesh.world)
    n, b_max, q_max, bounds = sh["n"], sh["b_max"], sh["q_max"], sh["bounds"]
    dstT_l, cs_l, degc_l = host_sharded(mesh, lambda d: pack_shard_block(
        d, sh["colstart"], sh["dstT"], sh["degc_all"], bounds, b_max,
        q_max, n))
    got = {k: sh[k] for k in ("n", "b_max", "q_max", "q_total", "degc",
                              "total_chunks", "layout", "shard_chunks",
                              "nunv_chip_max")}
    got.update(dstT=dstT_l, colstart=cs_l, degc_l=degc_l,
               degc_dev=host_replicated(mesh, sh["degc"]),
               lo=int(bounds[mesh.rank]), hi=int(bounds[mesh.rank + 1]))
    cache[mesh.key] = got
    return got


# ---------------------------------------------------------------------------
# the level steps on this rank's block
# ---------------------------------------------------------------------------

def _td_level(dist, level: int, f_count: int, sh: dict, f_cap: int,
              p_cap: int) -> None:
    """Top-down: the frontier list from the replicated ``dist``, and the
    rank's owned share of it expanded through its block, into ``dist``
    in place."""
    n, b_max, lo, hi = sh["n"], sh["b_max"], sh["lo"], sh["hi"]
    dstT, cs_l, degc_l = sh["dstT"], sh["colstart"], sh["degc_l"]
    _, frontier = compact_ids(dist[:n] == level, f_cap, n + 1)
    valid = (torch.arange(f_cap, device=dist.device) < f_count) \
        & (frontier >= lo) & (frontier < hi)
    v = (frontier - lo).clamp(0, b_max - 1).long()
    cols, _, _ = enumerate_chunk_pairs(valid, degc_l[v], cs_l[v], p_cap,
                                       dstT.shape[1] - 1)
    nbr = dstT[:, cols.long()].reshape(-1)            # pad n+1 -> spare
    dist.scatter_reduce_(0, nbr.long(), torch.full_like(nbr, level + 1),
                         reduce="amin")


def _bu_open(dist, level: int, sh: dict, c_cap: int):
    """Bottom-up opener on the block: the candidates (unvisited block
    vertices with chunks, LOCAL ids padded with b_max), then ONE
    ``frontier_round`` for chunk 0. Returns ``(fbits, cand, off, prog)``,
    ``prog`` = [survivors, their remaining chunk mass]."""
    n, b_max, lo, hi = sh["n"], sh["b_max"], sh["lo"], sh["hi"]
    dstT, cs_l, degc_l = sh["dstT"], sh["colstart"], sh["degc_l"]
    dev = dist.device
    fbits = _pack_bits(dist, level, n)
    block = torch.arange(b_max, device=dev)
    cand_mask = (block < hi - lo) & (dist[(block + lo).clamp(max=n)] >= INF) \
        & (degc_l > 0)
    c_count, cand = compact_ids(cand_mask, c_cap, b_max)
    alive = torch.arange(c_cap, device=dev) < c_count
    v = cand.clamp(0, b_max - 1).long()
    dv = degc_l[v]
    cols = torch.where(alive, cs_l[v], dstT.shape[1] - 1)
    found, cand, off, nc = frontier_round(
        cols, alive[None, :], alive & (dv > 1), cand,
        torch.ones(c_cap, dtype=torch.int32, device=dev), fbits[None, :],
        None, dstT, lanes=SPLIT_LANES, fill0=b_max, fill1=0)
    _set_level(dist, found[0], v + lo, level, n)
    surv = alive & ~found[0] & (dv > 1)
    rem8 = torch.where(surv, dv - 1, 0).sum(dtype=torch.int32)
    return fbits, cand, off, torch.stack([nc, rem8])


def _bu_rounds(dist, fbits, cand, off, c_count, level: int, sh: dict,
               fuse: int):
    """``fuse`` chunk rounds over the compacted survivors, each one
    ``frontier_round``; the count stays on the device between rounds.
    Returns ``(cand, off, prog)``."""
    n, b_max, lo = sh["n"], sh["b_max"], sh["lo"]
    dstT, cs_l, degc_l = sh["dstT"], sh["colstart"], sh["degc_l"]
    q_pad = dstT.shape[1] - 1
    slots = torch.arange(cand.shape[0], device=dist.device)
    for _ in range(fuse):
        alive = slots < c_count
        v = cand.clamp(0, b_max - 1).long()
        cols = torch.where(alive, cs_l[v] + off, q_pad)
        found, cand, off, c_count = frontier_round(
            cols, alive[None, :], alive & (off + 1 < degc_l[v]), cand,
            off + 1, fbits[None, :], None, dstT, lanes=SPLIT_LANES,
            fill0=b_max, fill1=0)
        _set_level(dist, found[0], v + lo, level, n)
    alive = slots < c_count
    v = cand.clamp(0, b_max - 1).long()
    rem = torch.where(alive, (degc_l[v] - off).clamp(min=0), 0) \
        .sum(dtype=torch.int32)
    return cand, off, torch.stack([c_count, rem])


def _bu_exhaust(dist, fbits, cand, off, c_count: int, level: int,
                sh: dict, p_cap: int) -> None:
    """One sweep over ALL remaining chunks of the surviving candidates
    (the single-card hybrid's straggler sweep, on the block)."""
    n, b_max, lo = sh["n"], sh["b_max"], sh["lo"]
    dstT, cs_l, degc_l = sh["dstT"], sh["colstart"], sh["degc_l"]
    c_cap = cand.shape[0]
    valid = torch.arange(c_cap, device=dist.device) < c_count
    v = cand.clamp(0, b_max - 1).long()
    rem = (degc_l[v] - off).clamp(min=0)
    cols, p_total, owner = enumerate_chunk_pairs(
        valid, rem, cs_l[v] + off, p_cap, dstT.shape[1] - 1,
        with_owner=True)
    hit = _bit_of(fbits, dstT[:, cols.long()]).any(dim=0)
    found = valid & (_found_per(hit, owner, p_total, c_cap) > 0)
    _set_level(dist, found, v + lo, level, n)


def _bu_level(dist, level: int, sh: dict, c_cap: int) -> None:
    """Bottom-up on the block: the opener, the remaining chunk rounds at
    the survivors' width, then the sweep for what is left."""
    fbits, cand, off, prog = _bu_open(dist, level, sh, c_cap)
    nc, rem = prog.tolist()
    if nc > 0:
        w = next_pow2(max(nc, 2))
        cand, off, prog = _bu_rounds(dist, fbits, cand[:w], off[:w], nc,
                                     level, sh, BU_CHUNK_ROUNDS - 1)
        nc, rem = prog.tolist()
    if nc > 0:
        w = next_pow2(max(nc, 2))
        _bu_exhaust(dist, fbits, cand[:w], off[:w], nc, level, sh,
                    next_pow2(max(rem, 2)))


def _exchange_tail(dist, newly, level: int, sh: dict, found_cap: int,
                   mesh: VertexMesh):
    """The exchange and the stats: every rank's newly-found ids gathered
    and merged into ``dist`` in place, then ``[nf, m8_f, m8_unvis,
    found_max, m8f_chip, nunv_chip]`` (int32) with the per-chip entries
    the maxima over the ranks."""
    n, lo, hi = sh["n"], sh["lo"], sh["hi"]
    degc, degc_l = sh["degc_dev"][:n], sh["degc_l"][:hi - lo]
    all_ids, found_max = exchange_found(newly, found_cap, n, mesh)
    dist[all_ids.reshape(-1).long()] = level + 1      # fill n+1 -> spare
    d = dist[:n]
    changed = d == level + 1
    unvis = d >= INF
    blk = dist[lo:hi]
    chip = mesh.all_reduce(torch.stack([
        torch.where(blk == level + 1, degc_l, 0).sum(dtype=torch.int32),
        ((blk >= INF) & (degc_l > 0)).sum(dtype=torch.int32)]), "max")
    return torch.stack([
        changed.sum(dtype=torch.int32),
        torch.where(changed, degc, 0).sum(dtype=torch.int32),
        torch.where(unvis, degc, 0).sum(dtype=torch.int32),
        found_max, chip[0], chip[1]])


def frontier_bfs_hybrid_sharded(snap_or_graph, source_dense: int,
                                mesh: VertexMesh, max_levels: int = 1000,
                                return_device: bool = False):
    """Direction-optimizing BFS over the mesh (see the module doc); every
    rank calls it with the same arguments. Returns ``(dist [n] int32
    with INF unreachable, levels)``, a tensor on the rank's device when
    ``return_device`` else numpy, the same on every rank."""
    sh = rank_shard(snap_or_graph, mesh)
    n, b_max = sh["n"], sh["b_max"]
    cap_n = next_pow2(max(n, 2))
    cap_b = next_pow2(max(b_max, 2))
    cap_q = next_pow2(max(sh["q_max"], 2))
    f_count = 1
    m8_f = int(sh["degc"][source_dense])
    m8_unvis = sh["total_chunks"] - m8_f
    nunv_chip = sh["nunv_chip_max"]
    m8f_chip = m8_f
    dist = torch.full((n + 2,), INF, dtype=torch.int32, device=mesh.device)
    dist[source_dense] = 0
    level = 0
    # level-0 discoveries are bounded by the source's degree: seed the
    # exchange cap from it instead of always paying an overflow retry
    found_guess = min(next_pow2(max(8 * m8_f, 4)), cap_n)
    LAST_EXCHANGE_CAPS.clear()
    LAST_PROFILE.clear()
    while f_count > 0 and level < max_levels:
        use_bu = m8_f * ALPHA > m8_unvis and f_count > 1
        if not use_bu and m8_f == 0:
            break
        bu_caps = {}
        if use_bu:
            c_cap = min(next_pow2(max(nunv_chip, 2)), cap_b)
            bu_caps = {"c_cap": c_cap}
            _bu_level(dist, level, sh, c_cap)
        else:
            f_cap = min(next_pow2(max(f_count, 2)), cap_n)
            # p_cap covers the heaviest rank's OWNED frontier mass (a
            # vertex expands on its owner only)
            p_cap = min(next_pow2(max(m8f_chip, 2)), cap_q)
            _td_level(dist, level, f_count, sh, f_cap, p_cap)
        newly = dist[:n] == level + 1
        found_cap, retries = found_guess, 0
        while True:
            st_h = _exchange_tail(dist, newly, level, sh, found_cap,
                                  mesh).tolist()
            found_max = st_h[ST_FOUNDMAX]
            if found_max <= found_cap:
                (f_count, m8_f, m8_unvis, found_max, m8f_chip,
                 nunv_chip) = st_h
                break
            found_cap = next_pow2(max(found_max, 2))
            retries += 1
        LAST_EXCHANGE_CAPS.append(found_cap)
        LAST_PROFILE.append({
            "level": level, "mode": "bu" if use_bu else "td",
            "nf": f_count, "m8_f": m8_f,
            "found_max_per_chip": found_max, "found_cap": found_cap,
            "exchanged_ids": mesh.world * found_cap, "retries": retries,
            "dispatches": 1 + retries,
            "bu_dispatches": (1 + retries) if use_bu else 0,
            "bu_trail": ([{"step": "bu_fused", **bu_caps,
                           "retries": retries}] if use_bu else [])})
        found_guess = min(next_pow2(max(4 * found_max, 4)), cap_n)
        level += 1
    out = dist[:n]
    return (out if return_device else out.cpu().numpy()), level
