"""Vertex-block partitioning and the sparse exchange (port of
``titan_tpu/parallel/partition.py``).

Vertices are cut into D contiguous dense ranges; the engine's edges go to
the shard that owns their destination (pull layout), each keeping global
source indices, so a superstep needs one all-gather of the state and a
local gather and segment combine. Blocks are padded to the JAX package's
shapes (padded edges point at a per-shard sink segment, ``block``, and
are masked with the combine identity), so a rank's block equals the JAX
package's row of it.

* :func:`shard_csr` packs the engine's blocks: all D, or only the given
  ranks (a rank packs its own);
* :class:`BlockLayout` / :func:`block_layout` describe the sharded BFS's
  edge-balanced blocks;
* :func:`exchange_found` is the BFS's sparse exchange: each rank's
  newly-found ids compacted to a cap and all-gathered, O(frontier)
  communication.

The JAX package's ``place_shards`` / ``place_replicated`` become the
rank-local uploads of ``multihost.host_sharded`` / ``host_replicated``.

* :func:`place_batched_csr` / :func:`batched_state_sharding` place the
  serving plane's batched cohort over a one-process ``LocalMesh``. JAX
  shards ``dstT``'s chunk columns over ``"v"`` and lets GSPMD partition
  the unchanged batched kernels; PyTorch has no GSPMD, so the port cuts
  the vertices into ``mesh.size`` blocks (``block_layout`` balanced by
  chunk columns, the cuts on multiples of 8 vertices) and gives each
  block a chunked CSR of its own on its device, which
  ``models/bfs_hybrid.frontier_bfs_batched`` drives block by block.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from titan_tpu_torch.obs import devprof
from titan_tpu_torch.ops.compaction import compact_ids
from titan_tpu_torch.ops.segment import segment_metadata
from titan_tpu_torch.parallel.mesh import VERTEX_AXIS, LocalMesh, VertexMesh

_ALIGN = 1024  # edge blocks padded to multiples of this, as in JAX


@dataclass
class ShardedCSR:
    """The engine's blocks. The arrays hold one row for each rank of
    ``ranks`` (all D, or the ones asked for), in that order."""

    n: int                      # true vertex count
    n_pad: int                  # D * block
    block: int                  # vertices per shard
    num_shards: int
    e_block: int                # edges per shard (padded)
    src_global: np.ndarray      # [R, e_block] int32
    dst_local: np.ndarray       # [R, e_block] int32 in [0, block]; block = sink
    valid: np.ndarray           # [R, e_block] bool
    last_idx: np.ndarray        # [R, block+1] int32 scan metadata (ops/segment)
    seg_has: np.ndarray         # [R, block+1] bool
    edge_values: dict = field(default_factory=dict)  # name -> [R, e_block]
    ranks: tuple = ()


def shard_csr(snap, num_shards: int, align: int = _ALIGN,
              ranks: Optional[Sequence[int]] = None) -> ShardedCSR:
    """The engine's destination-owned blocks of a dst-sorted snapshot,
    padded to JAX's shapes; ``ranks`` packs only those rows (default
    all)."""
    n = snap.n
    block = -(-max(n, 1) // num_shards)          # ceil
    block = -(-block // 8) * 8                   # 8-aligned vertex blocks
    n_pad = block * num_shards
    ranks = tuple(range(num_shards)) if ranks is None else tuple(ranks)
    bounds = np.searchsorted(snap.dst, np.arange(0, n_pad + 1, block))
    counts = np.diff(bounds)
    e_block = int(max(counts.max() if len(counts) else 0, 1))
    e_block = -(-e_block // align) * align
    r = len(ranks)
    src_g = np.zeros((r, e_block), dtype=np.int32)
    dst_l = np.full((r, e_block), block, dtype=np.int32)       # sink
    valid = np.zeros((r, e_block), dtype=bool)
    last_idx = np.zeros((r, block + 1), dtype=np.int32)
    seg_has = np.zeros((r, block + 1), dtype=bool)
    evs = {name: np.zeros((r, e_block), dtype=np.asarray(v).dtype)
           for name, v in snap.edge_values.items()}
    for i, d in enumerate(ranks):
        lo, hi = bounds[d], bounds[d + 1]
        m = hi - lo
        src_g[i, :m] = snap.src[lo:hi]
        dst_l[i, :m] = snap.dst[lo:hi] - d * block
        valid[i, :m] = True
        for name, v in snap.edge_values.items():
            evs[name][i, :m] = v[lo:hi]
        # scan metadata over the local (block+1)-segment layout, sink last
        indptr_l = np.zeros(block + 2, dtype=np.int64)
        np.cumsum(np.bincount(dst_l[i], minlength=block + 1),
                  out=indptr_l[1:])
        li, sh = segment_metadata(indptr_l)
        last_idx[i] = li[:block + 1]
        seg_has[i] = sh[:block + 1]
    return ShardedCSR(n, n_pad, block, num_shards, e_block, src_g, dst_l,
                      valid, last_idx, seg_has, evs, ranks)


@dataclass(frozen=True)
class BlockLayout:
    """The vertex-block layout of a D-way mesh: edge-balanced contiguous
    vertex ranges over the chunk prefix, with the padded per-shard widths.

    ``bounds`` is always ``num_shards + 1`` long (trailing shards past the
    live ones own empty ranges). ``b_max``/``q_max`` are the padded
    per-shard vertex and chunk-column widths (``q_max`` includes the
    local sink column and is int32-guarded). ``shard_chunks`` is each
    live shard's chunk mass; ``nunv_cap`` bounds one shard's expandable
    vertices, the first bottom-up level's candidate cap."""

    n: int
    num_shards: int
    bounds: tuple
    b_max: int
    q_max: int
    shard_chunks: tuple
    nunv_cap: int

    @property
    def live_shards(self) -> int:
        return len(self.shard_chunks)

    def balance(self) -> float:
        """max/min chunk mass over live shards (1.0 = perfect)."""
        if not self.shard_chunks:
            return 1.0
        return max(self.shard_chunks) / max(min(self.shard_chunks), 1)

    def block_window(self, d: int) -> tuple:
        """(lo, hi) dense vertex range owned by shard ``d``."""
        return int(self.bounds[d]), int(self.bounds[d + 1])

    def describe(self) -> dict:
        return {"n": self.n, "num_shards": self.num_shards,
                "b_max": self.b_max, "q_max": self.q_max,
                "shard_chunks": list(self.shard_chunks),
                "balance_max_over_min": round(self.balance(), 3),
                "nunv_cap": self.nunv_cap}


def block_layout(colstart: np.ndarray, degc_all: np.ndarray, n: int,
                 num_shards: int, align: int = 1) -> BlockLayout:
    """Plan the edge-balanced vertex-block layout (through
    ``bfs_hybrid_sharded.plan_shard_cuts``, the inner cuts rounded to
    multiples of ``align``)."""
    from titan_tpu_torch.models.bfs_hybrid_sharded import (
        plan_shard_cuts, shard_unvisited_cap)

    bounds, b_max, q_max = plan_shard_cuts(colstart, n, num_shards, align)
    d_eff = len(bounds) - 1
    bounds_full = np.zeros(num_shards + 1, np.int64)
    bounds_full[:len(bounds)] = bounds
    bounds_full[len(bounds):] = n
    chunks = tuple(int(colstart[bounds[d + 1]] - colstart[bounds[d]])
                   for d in range(d_eff))
    return BlockLayout(int(n), int(num_shards),
                       tuple(int(b) for b in bounds_full),
                       int(b_max), int(q_max), chunks,
                       shard_unvisited_cap(degc_all, bounds))


def exchange_found(newly_mask, found_cap: int, n: int, mesh: VertexMesh):
    """The frontier exchange: compact this rank's newly-found vertex mask
    into a ``found_cap``-sized id list (``ops.compaction``, no n-wide
    nonzero) and all-gather only those lists, O(frontier) communication.
    Returns ``(all_ids [D, found_cap] int32 with fill n+1, found_max)``,
    ``found_max`` the largest true count of any rank (a 0-d tensor): the
    caller retries with the exact cap when it exceeds ``found_cap``."""
    cnt = newly_mask.sum(dtype=torch.int32)
    _, ids = compact_ids(newly_mask, found_cap, n + 1)
    all_ids = mesh.all_gather(ids)                  # [D, found_cap]
    return all_ids, mesh.all_reduce(cnt, "max")


@dataclass(frozen=True)
class StateSharding:
    """The port's descriptor of a mesh-placed cohort's ``[K, n+1]``
    state (JAX's ``NamedSharding(mesh, P(None, "v"))``): the vertex axis
    split over ``mesh``'s devices in the placed graph's blocks, K whole
    on each."""

    mesh: LocalMesh
    spec: tuple = (None, VERTEX_AXIS)


def batched_state_sharding(mesh: LocalMesh) -> StateSharding:
    """The ``[K, n+1]`` dist placement of mesh-placed batched runs:
    vertex axis split over the mesh, K replicated."""
    return StateSharding(mesh)


#: the placements of a snapshot or a graph dict, by mesh (the JAX
#: package's ``_meshed`` holds one)
MESH_CACHE = "_batched_csr_by_mesh"

#: the mesh-placed blocks start on multiples of this many vertices, so a
#: block's frontier words start on a byte at any bits-a-vertex
#: (``ops/frontier.word_bits``: at most 32 bits, at least 1)
BLOCK_ALIGN = 8


def _host_chunked(snap_or_graph):
    """``(dstT [8, Q] int32, colstart int64 [n+1], degc int64 [n], n)``
    on the host: a snapshot's chunked layout, or a graph dict's arrays
    (a device dict of ``build_chunked_csr``/``graph_from_numpy`` read
    back, or a host dict of ``graph500.load_or_build``)."""
    from titan_tpu_torch.models.bfs_hybrid import chunked_layout

    def host(a):
        return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

    if not isinstance(snap_or_graph, dict):
        snap = snap_or_graph
        dst_by_src, indptr = snap.out_csr()
        deg = np.asarray(snap.out_degree).astype(np.int64)
        dstT, colstart, degc, _ = chunked_layout(dst_by_src, indptr, deg,
                                                 snap.n)
        return dstT, colstart, degc, snap.n
    g = snap_or_graph
    colstart = host(g["colstart"]).astype(np.int64)
    n = colstart.shape[0] - 1
    if "degc" in g:
        degc = host(g["degc"])[:n].astype(np.int64)
    else:
        degc = -(-host(g["deg"])[:n].astype(np.int64) // 8)
    return host(g["dstT"]), colstart, degc, n


def place_batched_csr(snap_or_graph, mesh: LocalMesh) -> dict:
    """The chunked CSR placed over a one-process mesh for the batched
    BFS: the vertices cut into ``mesh.size`` blocks by ``block_layout``
    (balanced by chunk columns, the inner cuts on multiples of
    ``BLOCK_ALIGN`` vertices), and on each block's device its chunked
    CSR: its ``dstT`` columns plus a pad column of its own (``n+1``),
    ``colstart`` re-based to its columns, its ``degc`` (0 at the pad
    vertex), its bounds. The payload stays the global vertex ids. A
    block the cuts leave empty holds nothing.

    ``snap_or_graph`` is a snapshot (duck-typed, as ``build_chunked_csr``
    takes it) or a graph dict, on the device or on the host. The result
    holds ``n``, ``q_total``, ``_mesh``, ``_state_sharding``
    (``batched_state_sharding(mesh)``, so ``"_state_sharding" in placed``
    reads as in JAX), ``_layout`` and ``_shards``, and is cached on the
    snapshot or the dict under ``MESH_CACHE`` by mesh. The snapshot's
    ``refresh()``, ``apply_changes`` and ``rebuild_in_place`` drop it
    (``GraphSnapshot._DEVICE_CACHES``), as does the serving scheduler's
    eviction. Each block's upload counts on ``obs/devprof``'s
    ``parallel.batched_csr`` H2D site."""
    if not isinstance(mesh, LocalMesh):
        raise TypeError(f"place_batched_csr takes a LocalMesh "
                        f"(parallel.mesh.local_mesh), got "
                        f"{type(mesh).__name__}; one process drives the "
                        "cohort, as in the JAX package")
    owner = snap_or_graph
    is_dict = isinstance(owner, dict)
    cache = owner.get(MESH_CACHE) if is_dict \
        else getattr(owner, MESH_CACHE, None)
    if cache is not None and mesh in cache:
        return cache[mesh]
    dstT, colstart, degc, n = _host_chunked(owner)
    layout = block_layout(colstart, degc, n, mesh.size, align=BLOCK_ALIGN)
    shards = []
    for d, dev in enumerate(mesh.devices):
        lo, hi = layout.block_window(d)
        if lo >= hi:
            continue
        c0, c1 = int(colstart[lo]), int(colstart[hi])
        dstT_b = np.full((8, c1 - c0 + 1), n + 1, np.int32)
        dstT_b[:, :c1 - c0] = dstT[:, c0:c1]
        cs_b = (colstart[lo:hi + 1] - c0).astype(np.int32)
        degc_b = np.concatenate([degc[lo:hi], [0]]).astype(np.int32)
        devprof.count_h2d("parallel.batched_csr", dstT_b.nbytes
                          + cs_b.nbytes + degc_b.nbytes)
        shards.append({"device": dev, "lo": lo, "hi": hi, "c0": c0,
                       "n": hi - lo, "q_total": c1 - c0 + 1,
                       "dstT": torch.from_numpy(dstT_b).to(dev),
                       "colstart": torch.from_numpy(cs_b).to(dev),
                       "degc": torch.from_numpy(degc_b).to(dev)})
    placed = {"n": n, "q_total": int(dstT.shape[1]), "_mesh": mesh,
              "_state_sharding": batched_state_sharding(mesh),
              "_layout": layout, "_shards": shards}
    if cache is None:
        cache = {}
        if is_dict:
            owner[MESH_CACHE] = cache
        else:
            try:
                setattr(owner, MESH_CACHE, cache)
            except AttributeError:        # __slots__ or a frozen object
                return placed
    cache[mesh] = placed
    return placed


__all__ = ["BLOCK_ALIGN", "MESH_CACHE", "VERTEX_AXIS", "BlockLayout",
           "ShardedCSR", "StateSharding", "batched_state_sharding",
           "block_layout", "exchange_found", "place_batched_csr", "shard_csr"]
