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
Its mesh-placed batched cohort (``batched_state_sharding``,
``place_batched_csr``) rests on GSPMD, which PyTorch lacks; it is the
serving plane's ``mesh=`` and raises here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from titan_tpu_torch.errors import not_ported
from titan_tpu_torch.ops.compaction import compact_ids
from titan_tpu_torch.ops.segment import segment_metadata
from titan_tpu_torch.parallel.mesh import VERTEX_AXIS, VertexMesh

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
                 num_shards: int) -> BlockLayout:
    """Plan the edge-balanced vertex-block layout (through
    ``bfs_hybrid_sharded.plan_shard_cuts``)."""
    from titan_tpu_torch.models.bfs_hybrid_sharded import (
        plan_shard_cuts, shard_unvisited_cap)

    bounds, b_max, q_max = plan_shard_cuts(colstart, n, num_shards)
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


def batched_state_sharding(mesh):
    """The mesh-placed ``[K, n+1]`` state of a batched cohort: the serving
    plane's ``mesh=``, not ported."""
    raise not_ported("batched_state_sharding (a mesh-placed cohort)",
                     item=9)


def place_batched_csr(snap_or_graph, mesh) -> dict:
    """The chunked CSR placed over a mesh for the batched kernels: the
    serving plane's ``mesh=``, not ported (JAX's rests on GSPMD)."""
    raise not_ported("place_batched_csr (a mesh-placed cohort)", item=9)


__all__ = ["VERTEX_AXIS", "BlockLayout", "ShardedCSR", "batched_state_sharding",
           "block_layout", "exchange_found", "place_batched_csr", "shard_csr"]
