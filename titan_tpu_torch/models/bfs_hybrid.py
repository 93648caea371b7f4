"""Direction-optimizing (top-down/bottom-up) frontier BFS on a CUDA card,
and the batched [K, n] BFS of the serving layer (port of
``titan_tpu/models/bfs_hybrid.py``'s single-source and batched paths).

Layout, as in the JAX package: the out-CSR is stored transposed and
8-aligned — ``dstT[j, q] = neighbor j of chunk q`` — with every vertex's
segment padded to whole 8-lane columns (pad = ``n+1``) and one trailing
all-pad sink column. SYMMETRIC GRAPHS ONLY: bottom-up treats a vertex's
out-neighbors as its potential parents.

The driver keeps the JAX package's level structure and thresholds: a
head loop of early top-down levels with claim-array dedup, top-down
steps, the bottom-up opener and chunk rounds — always through the
``frontier_round`` kernel (the Pallas-mode branch of the JAX driver) —
the exhaustive straggler sweep, and the endgame that finishes every
trailing level. ``lax.while_loop``/``lax.scan`` become Python loops and
``lax.cond`` an ``if`` on a scalar already read back: one ``.tolist()``
per level or round.

JAX semantics kept by hand:

* ``dist`` is allocated [n+2]. Index ``n+1`` (the pad) is a spare slot
  that absorbs the scatters JAX drops (``mode="drop"``); nothing reads
  it. ``dist[n]`` is never written and stays INF.
* Gathers that JAX clamps (``dist[nbr]``) clamp to ``n`` explicitly, so
  a pad lane reads INF.
* Scatters with duplicate indices are min/max reductions
  (``scatter_reduce_``), whose result does not depend on order.
* Counts and mass sums stay int32 (``dtype=torch.int32``), as with JAX's
  x64 off; the mode switch keeps its integer form.

``dist`` is updated in place across the level steps. The batched family
(``frontier_bfs_batched``, below) has its own notes.
"""

from __future__ import annotations

import numpy as np
import torch

from titan_tpu_torch.device import INF, cache_key, next_pow2, resolve_device
from titan_tpu_torch.obs import devprof
from titan_tpu_torch.ops.compaction import (CLAIM_SENTINEL, claim_dedup,
                                            claim_reset, compact_ids,
                                            scatter_compact)
from titan_tpu_torch.ops.frontier import (batched_exhaust, frontier_round,
                                          job_bits, plane_bytes, word_bits,
                                          words_at)

# mode-switch thresholds (Beamer-style), identical to the JAX package:
# td->bu when the frontier's chunked edge mass exceeds 1/ALPHA of the
# remaining unvisited mass (integer form m8_f > m8_unvis // 8 on device)
ALPHA = 8.0
# after this many 8-edge chunks checked per candidate, survivors go to the
# exhaustive sweep
BU_CHUNK_ROUNDS = 8
# leading lanes the frontier_round ladder tests before the 8-lane refetch
SPLIT_LANES = 2
# head loop caps: early top-down levels run while the frontier stays under
HEAD_F_CAP = 1 << 12
HEAD_P_CAP = 1 << 18
# endgame entry: remaining unvisited vertex / chunk mass caps
END_C_CAP = 1 << 21
END_P_CAP = 1 << 22


def layout_slot_positions(indptr, deg, n: int):
    """Edge -> slot index (``col*8 + lane``) in the 8-aligned transposed
    chunk layout, in payload order. Returns ``(pos int64 [E], colstart
    int64 [n+1], degc int64 [n])``."""
    degc = -(-deg // 8)
    colstart = np.zeros(n + 1, np.int64)
    np.cumsum(degc, out=colstart[1:])
    total = int(indptr[n])
    pos = np.repeat(colstart[:n] * 8 - indptr[:n], deg[:n]) \
        + np.arange(total, dtype=np.int64)
    return pos, colstart, degc


def chunked_layout(payload, indptr, deg, n: int):
    """The 8-aligned transposed chunk layout. Returns ``(dstT [8, Q]
    int32, colstart int64 [n+1], degc int64 [n], q_total)``."""
    pos, colstart, degc = layout_slot_positions(indptr, deg, n)
    q_total = int(colstart[-1]) + 1          # +1 all-pad column for the sink
    if q_total >= (1 << 31):
        raise NotImplementedError(
            "chunked CSR uses int32 COLUMN indices; shard below 2^31 chunks")
    flat = np.full(q_total * 8, n + 1, np.int32)
    flat[pos] = payload
    dstT = np.ascontiguousarray(flat.reshape(q_total, 8).T)
    return dstT, colstart, degc, q_total


def build_chunked_csr(snap, device=None) -> dict:
    """Chunked out-CSR of a snapshot on ``device``. Duck-typed: needs
    ``snap.n``, ``snap.out_csr()`` -> (dst_by_src, indptr) and
    ``snap.out_degree``. Returns ``dstT`` [8, Q] int32, ``colstart``
    [n+1] int32, ``degc`` and ``deg`` [n+1] int32 (0 for the sink),
    ``q_total`` and ``n``.

    Cached on the snapshot as the JAX package caches its own, in
    ``snap._hybrid_csr_by_device``, a dict keyed by device: a second call
    on the same device returns the same dict and tensors, with no host
    build and no upload; deleting the attribute (the serving scheduler's
    eviction) drops every device's copy. The name differs from the JAX
    package's ``_hybrid_csr`` (one flat graph) because one snapshot
    object may be handed to both packages, and each must find only its
    own cache on it. A snapshot that cannot take the attribute is built
    every call. Each upload counts once on ``obs/devprof``'s
    ``bfs.chunked_csr`` H2D site."""
    dev = cache_key(device)
    cache = getattr(snap, "_hybrid_csr_by_device", None)
    if cache is not None and dev in cache:
        return cache[dev]
    n = snap.n
    dst_by_src, indptr_out = snap.out_csr()
    deg = np.asarray(snap.out_degree).astype(np.int64)
    dstT, colstart, degc, q_total = chunked_layout(
        dst_by_src, indptr_out, deg, n)
    devprof.count_h2d("bfs.chunked_csr", dstT.nbytes + 3 * (n + 1) * 4)
    out = {"dstT": torch.from_numpy(dstT).to(dev),
           "colstart": torch.from_numpy(colstart.astype(np.int32)).to(dev),
           "degc": torch.from_numpy(
               np.concatenate([degc, [0]]).astype(np.int32)).to(dev),
           "deg": torch.from_numpy(
               np.concatenate([deg, [0]]).astype(np.int32)).to(dev),
           "q_total": q_total, "n": n}
    if cache is None:
        cache = {}
        try:
            snap._hybrid_csr_by_device = cache
        except AttributeError:        # __slots__ or a frozen object
            return out
    cache[dev] = out
    return out


def enumerate_chunk_pairs(valid, counts, colstarts, p_cap: int, q_pad: int,
                          with_owner: bool = False):
    """Enumerate (item, chunk) pairs with the delta-scatter + cumsum trick.

    ``valid`` [f_cap] bool, ``counts`` [f_cap] chunks per item,
    ``colstarts`` [f_cap] each item's first column. Returns ``(cols
    [p_cap] int32 clipped to q_pad with dead pairs = q_pad, p_total,
    owner [p_cap] or None)``. Starts at or past ``p_cap`` are dropped
    into a spare slot."""
    dev = valid.device
    f_cap = valid.shape[0]
    counts = torch.where(valid, counts, 0).to(torch.int32)
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    starts = ends - counts
    p_total = ends[-1]
    at = torch.where(starts < p_cap, starts, p_cap).long()
    base = torch.where(valid, colstarts, 0) - starts
    delta = torch.diff(base, prepend=base.new_zeros(1))
    acc = torch.zeros(p_cap + 1, dtype=torch.int32, device=dev)
    acc.index_add_(0, at, delta.to(torch.int32))
    j = torch.arange(p_cap, dtype=torch.int32, device=dev)
    cols = torch.cumsum(acc[:p_cap], 0, dtype=torch.int32) + j
    cols = torch.where(j < p_total, cols.clamp(0, q_pad), q_pad)
    if not with_owner:
        return cols, p_total, None
    item = torch.arange(f_cap, dtype=torch.int32, device=dev)
    oacc = torch.zeros(p_cap + 1, dtype=torch.int32, device=dev)
    oacc.index_add_(0, at, torch.diff(item, prepend=item.new_zeros(1)))
    owner = torch.cumsum(oacc[:p_cap], 0, dtype=torch.int32) \
        .clamp(0, f_cap - 1)
    return cols, p_total, owner


def _pack_bits(dist, level: int, n_: int):
    """Frontier bitmap: bit v = (dist[v] == level), little-endian within
    bytes, ``(n_+2+7)//8`` bytes (covers the pad vertex n_+1, always 0)."""
    nbytes = (n_ + 2 + 7) // 8
    bits = torch.zeros(nbytes * 8, dtype=torch.int32, device=dist.device)
    bits[:n_ + 1] = (dist[:n_ + 1] == level).to(torch.int32)
    weight = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                          device=dist.device)
    return (bits.view(nbytes, 8) * weight).sum(dim=1).to(torch.uint8)


def _bit_of(fbits, idx):
    """Test bitmap bits at int32 indices (any shape)."""
    w = fbits[(idx >> 3).long()].to(torch.int32)
    return ((w >> (idx & 7)) & 1) > 0


def _level_stats(dist, degc, level: int, n_: int):
    """[nf, m8_next, m8_unvis, n_unvis] (int32) after a level's writes
    landed (frontier now at dist == level+1)."""
    d, dc = dist[:n_], degc[:n_]
    changed = d == level + 1
    unvis = d >= INF
    return torch.stack([
        changed.sum(dtype=torch.int32),
        torch.where(changed, dc, 0).sum(dtype=torch.int32),
        torch.where(unvis, dc, 0).sum(dtype=torch.int32),
        (unvis & (dc > 0)).sum(dtype=torch.int32)])


def _set_level(dist, found, v, level: int, n_: int):
    """dist[v] = level+1 where found; the rest land in the spare slot."""
    dist[torch.where(found, v, n_ + 1).long()] = level + 1


def _fit(a, cap: int, fill: int):
    """Pad a frontier list to ``cap`` (capacity buckets are powers of two
    and can exceed a list's natural length); longer lists stay as they
    are."""
    if a.shape[0] >= cap:
        return a
    return torch.cat([a, a.new_full((cap - a.shape[0],), fill)])


def _head_loop(g, source: int, max_lv: int, f_cap: int, p_cap: int):
    """Early top-down levels from the source while the frontier stays
    within (f_cap, p_cap) and top-down stays the right mode. The next
    frontier is deduped from the scatter targets with a claim array, and
    the unvisited-mass stats are kept as running differences, so no
    iteration does n-scale work. Returns ``(dist, frontier, [f_count,
    m8_f, m8_unvis, n_unvis, level])``."""
    n_ = g["n"]
    dstT, colstart, degc = g["dstT"], g["colstart"], g["degc"]
    dev = dstT.device
    q_pad = dstT.shape[1] - 1
    dist = torch.full((n_ + 2,), INF, dtype=torch.int32, device=dev)
    dist[source] = 0
    claim = torch.full((n_ + 2,), CLAIM_SENTINEL, dtype=torch.int32,
                       device=dev)
    frontier = torch.full((f_cap,), n_, dtype=torch.int32, device=dev)
    frontier[0] = source
    unvis = dist[:n_] >= INF
    m8_f, m8_unvis, n_unvis = torch.stack([
        degc[source],
        torch.where(unvis, degc[:n_], 0).sum(dtype=torch.int32),
        (unvis & (degc[:n_] > 0)).sum(dtype=torch.int32)]).tolist()
    f_count, level = 1, 0
    going = 0 < m8_f <= p_cap
    lane_id = torch.arange(8 * p_cap, dtype=torch.int32,
                           device=dev).view(8, p_cap)
    slots = torch.arange(f_cap, device=dev)
    while going and level < max_lv:
        valid = slots < f_count
        v = frontier.clamp(max=n_).long()
        cols, _, _ = enumerate_chunk_pairs(valid, degc[v], colstart[v],
                                           p_cap, q_pad)
        nbr = dstT[:, cols.long()]                       # [8, p_cap]
        # the dist gather reads PRE-scatter state: duplicates of one new
        # vertex all see INF and race on the claim, where one lane wins
        newly = torch.where(dist[nbr.clamp(max=n_).long()] >= INF, nbr,
                            n_ + 1)
        flat = nbr.reshape(-1).long()
        dist.scatter_reduce_(0, flat, torch.full_like(nbr.reshape(-1),
                                                      level + 1),
                             reduce="amin")
        claim, won = claim_dedup(claim, newly, lane_id)
        winner = won & (newly <= n_)
        degn = degc[newly.clamp(max=n_).long()]
        _, (nxt,) = scatter_compact(winner.reshape(-1),
                                    (newly.reshape(-1),), f_cap, (n_,))
        claim_reset(claim, newly)
        nf, m8_next, n_done = torch.stack([
            winner.sum(dtype=torch.int32),
            torch.where(winner, degn, 0).sum(dtype=torch.int32),
            (winner & (degn > 0)).sum(dtype=torch.int32)]).tolist()
        m8_unvis -= m8_next
        n_unvis -= n_done
        going = (0 < nf <= f_cap and m8_next <= p_cap
                 and not (m8_next > m8_unvis // 8 and nf > 1))
        frontier, f_count, m8_f, level = nxt, nf, m8_next, level + 1
    return dist, frontier, [f_count, m8_f, m8_unvis, n_unvis, level]


def _td_step(dist, frontier, f_count: int, level: int, g, p_cap: int):
    """One top-down level over the frontier list; returns the level
    stats. The next frontier list is built lazily by ``_frontier_of``,
    only when the next level stays top-down."""
    n_ = g["n"]
    dstT, colstart, degc = g["dstT"], g["colstart"], g["degc"]
    valid = torch.arange(frontier.shape[0], device=dist.device) < f_count
    v = frontier.clamp(max=n_).long()
    cols, _, _ = enumerate_chunk_pairs(valid, degc[v], colstart[v], p_cap,
                                       dstT.shape[1] - 1)
    nbr = dstT[:, cols.long()].reshape(-1)           # pad = n+1 -> spare
    dist.scatter_reduce_(0, nbr.long(), torch.full_like(nbr, level + 1),
                         reduce="amin")
    return _level_stats(dist, degc, level, n_)


def _bu_open(dist, level: int, g, c_cap: int):
    """Bottom-up opener: build the candidate list from dist, then ONE
    ``frontier_round`` does the chunk-0 narrow test, the wide refetch for
    the misses, and the survivor compaction. Returns ``(fbits, cand,
    prog)`` with ``prog`` = [survivors, their remaining chunk mass]."""
    n_ = g["n"]
    dstT, colstart, degc = g["dstT"], g["colstart"], g["degc"]
    q_pad = dstT.shape[1] - 1
    fbits = _pack_bits(dist, level, n_)
    unvis = (dist[:n_] >= INF) & (degc[:n_] > 0)
    c_count, cand = compact_ids(unvis, c_cap, n_)
    alive = torch.arange(c_cap, device=dist.device) < c_count
    v = cand.clamp(max=n_).long()
    dv = degc[v]
    cols = torch.where(alive, colstart[v], q_pad)
    found, cand2, _, nc = frontier_round(
        cols, alive[None, :], alive & (dv > 1), cand,
        torch.ones(c_cap, dtype=torch.int32, device=dist.device),
        fbits[None, :], None, dstT, lanes=SPLIT_LANES, fill0=n_, fill1=0)
    found0 = found[0]
    _set_level(dist, found0, v, level, n_)
    surv = alive & ~found0 & (dv > 1)
    rem8 = torch.where(surv, dv - 1, 0).sum(dtype=torch.int32)
    return fbits, cand2, torch.stack([nc, rem8])


def _bu_rounds(dist, fbits, cand, off, c_count: int, level: int, g,
               fuse: int):
    """``fuse`` >= 1 chunk rounds over the compacted survivor list, each
    one ``frontier_round``; the survivor count stays on the device
    between rounds. Returns ``(cand, off, prog)``, ``prog`` = [survivors,
    remaining chunk mass]."""
    n_ = g["n"]
    dstT, colstart, degc = g["dstT"], g["colstart"], g["degc"]
    q_pad = dstT.shape[1] - 1
    slots = torch.arange(cand.shape[0], device=dist.device)
    for _ in range(fuse):
        alive = slots < c_count
        v = cand.clamp(max=n_).long()
        cols = torch.where(alive, colstart[v] + off, q_pad)
        found, cand, off, c_count = frontier_round(
            cols, alive[None, :], alive & (off + 1 < degc[v]), cand,
            off + 1, fbits[None, :], None, dstT, lanes=SPLIT_LANES,
            fill0=n_, fill1=0)
        _set_level(dist, found[0], v, level, n_)
    alive = slots < c_count
    v = cand.clamp(max=n_).long()
    rem = torch.where(alive, (degc[v] - off).clamp(min=0), 0) \
        .sum(dtype=torch.int32)
    return cand, off, torch.stack([c_count, rem])


def _bu_exhaust(dist, fbits, cand, off, c_count: int, level: int, g,
                p_cap: int):
    """One sweep over ALL remaining chunks of the surviving candidates
    (rare: frontier-less hubs), then the level stats."""
    n_ = g["n"]
    dstT, colstart, degc = g["dstT"], g["colstart"], g["degc"]
    c_cap = cand.shape[0]
    valid = torch.arange(c_cap, device=dist.device) < c_count
    v = cand.clamp(max=n_).long()
    rem = (degc[v] - off).clamp(min=0)
    cols, p_total, owner = enumerate_chunk_pairs(
        valid, rem, colstart[v] + off, p_cap, dstT.shape[1] - 1,
        with_owner=True)
    hit = _bit_of(fbits, dstT[:, cols.long()]).any(dim=0)
    found = valid & (_found_per(hit, owner, p_total, c_cap) > 0)
    _set_level(dist, found, v, level, n_)
    return _level_stats(dist, degc, level, n_)


def _found_per(hit, owner, p_total, c_cap: int):
    """Per-candidate any-hit: max-scatter of each pair's hit through its
    owner (dead pairs go to the last candidate with their 0)."""
    j = torch.arange(hit.shape[0], device=hit.device)
    idx = torch.where(j < p_total, owner, c_cap - 1).long()
    return torch.zeros(c_cap, dtype=torch.int32, device=hit.device) \
        .scatter_reduce_(0, idx, hit.to(torch.int32), reduce="amax")


def _endgame(dist, level0: int, max_lv: int, g, c_cap: int, p_cap: int):
    """Finish the BFS: every remaining level as a full bottom-up sweep of
    the shrinking unvisited set, built once and re-compacted at c_cap
    width. Stops when a level finds nothing. Returns the number of
    levels that found something. Caller guarantee: n_unvis <= c_cap and
    m8_unvis <= p_cap."""
    n_ = g["n"]
    dstT, colstart, degc = g["dstT"], g["colstart"], g["degc"]
    q_pad = dstT.shape[1] - 1
    unvis = (dist[:n_] >= INF) & (degc[:n_] > 0)
    c_count, cand = compact_ids(unvis, c_cap, n_)
    slots = torch.arange(c_cap, device=dist.device)
    level, nfound, iters = level0, 1, 0
    while nfound > 0 and level < max_lv:
        fbits = _pack_bits(dist, level, n_)
        valid = slots < c_count
        v = cand.clamp(max=n_).long()
        cols, p_total, owner = enumerate_chunk_pairs(
            valid, degc[v], colstart[v], p_cap, q_pad, with_owner=True)
        hit = _bit_of(fbits, dstT[:, cols.long()]).any(dim=0)
        found = valid & (_found_per(hit, owner, p_total, c_cap) > 0)
        _set_level(dist, found, v, level, n_)
        surv = valid & ~found
        c_count, (cand,) = scatter_compact(surv, (v.to(torch.int32),),
                                           c_cap, (n_,))
        nfound = int(found.sum(dtype=torch.int32))
        level += 1
        iters += nfound > 0
    return iters


def _frontier_of(dist, level: int, n_: int):
    """The frontier list (dist == level), by scatter compaction."""
    return compact_ids(dist[:n_] == level, n_, n_)[1]


def frontier_bfs_hybrid(snap, source_dense: int, max_levels: int = 1000,
                        return_device: bool = False, device=None):
    """Direction-optimizing BFS from ``source_dense``. ``snap`` is a
    snapshot (duck-typed, see ``build_chunked_csr``) or a device graph
    dict (``olap.graph500.graph_from_numpy``) on ``device``. Returns
    ``(dist, levels)``; ``dist`` is int32 over [n] (INF = unreachable), a
    device tensor when ``return_device`` else numpy."""
    dev = resolve_device(device)
    ov = getattr(snap, "_live_overlay", None) \
        if not isinstance(snap, dict) else None
    if ov is not None and not ov.empty:
        # the single-source path has no overlay seam (its head and
        # endgame loops run whole level ranges) — batched BFS handles
        # overlays in the JAX package
        raise RuntimeError(
            "frontier_bfs_hybrid on a live overlay: use "
            "frontier_bfs_batched (overlay-aware) or compact the "
            "overlay first (LiveGraphPlane.compact_if_dirty)")
    g = snap if isinstance(snap, dict) else build_chunked_csr(snap, dev)
    if g["dstT"].device.type != dev.type:
        raise ValueError(f"graph lies on {g['dstT'].device}, device={dev}")
    n = g["n"]
    dstT, degc = g["dstT"], g["degc"]
    total_chunks = g["q_total"] - 1
    cap_n = next_pow2(max(n, 2))
    p_cap_all = next_pow2(max(total_chunks + n, 2))

    f_cap_h = min(HEAD_F_CAP, cap_n)
    p_cap_h = min(HEAD_P_CAP, p_cap_all)
    dist, frontier, st = _head_loop(g, int(source_dense), max_levels,
                                    f_cap_h, p_cap_h)
    f_count, m8_f, m8_unvis, n_unvis, level = st
    # a head refusal (source mass > p_cap_h) returns its initial state:
    # f_count=1, frontier=[source], level=0 — the main loop takes over
    frontier = _fit(frontier, cap_n, n) if f_count <= f_cap_h else None

    while f_count > 0 and level < max_levels:
        if n_unvis <= END_C_CAP and m8_unvis <= END_P_CAP:
            iters = _endgame(dist, level, max_levels, g,
                             next_pow2(max(n_unvis, 2)),
                             next_pow2(max(m8_unvis, 2)))
            # +1: the empty probe level, matching the host loop's count
            level = min(level + iters + 1, max_levels)
            break

        if not (m8_f * ALPHA > m8_unvis and f_count > 1):
            if m8_f == 0:
                break
            if frontier is None:      # after bottom-up / head overflow
                frontier = _fit(_frontier_of(dist, level, n), cap_n, n)
            f_cap = min(next_pow2(max(f_count, 2)), cap_n)
            p_cap = min(next_pow2(max(m8_f, 2)), p_cap_all)
            st = _td_step(dist, frontier[:f_cap], f_count, level, g, p_cap)
        else:
            c_cap = min(next_pow2(max(n_unvis, 2)), cap_n)
            fbits, cand, prog = _bu_open(dist, level, g, c_cap)
            nc, rem8 = prog.tolist()
            # the survivor list only shrinks, so each width c_cap2 (the
            # next power of two over the survivors) fits the list before
            rounds, off = 1, None
            while nc > 0 and rounds < BU_CHUNK_ROUNDS:
                c_cap2 = min(next_pow2(max(nc, 2)), cap_n)
                if off is None:
                    off = torch.ones(c_cap2, dtype=torch.int32,
                                     device=dstT.device)
                fuse = BU_CHUNK_ROUNDS - rounds
                cand, off, prog = _bu_rounds(dist, fbits, cand[:c_cap2],
                                             off[:c_cap2], nc, level, g,
                                             fuse)
                nc, rem8 = prog.tolist()
                rounds += fuse
            if nc > 0:
                # exhaustive sweep for the stragglers (stats included)
                c_cap2 = min(next_pow2(max(nc, 2)), cap_n)
                if off is None:
                    off = torch.ones(c_cap2, dtype=torch.int32,
                                     device=dstT.device)
                st = _bu_exhaust(dist, fbits, cand[:c_cap2], off[:c_cap2],
                                 nc, level, g, next_pow2(max(rem8, 2)))
            else:
                st = _level_stats(dist, degc, level, n)
        f_count, m8_f, m8_unvis, n_unvis = st.tolist()
        frontier = None
        level += 1
    out = dist[:n]
    return (out if return_device else out.cpu().numpy()), level


# --------------------------------------------------------------------------
# batched multi-source BFS: K concurrent jobs share one device run
# --------------------------------------------------------------------------
#
# The serving layer fuses K same-graph BFS jobs into one run with state
# widened to [K, n+2]: the per-level n-scale plan (candidate compaction and
# the per-job frontier counts) runs once for all K jobs, and every
# edge-chunk gather from dstT is read once and tested against all K
# frontiers inside frontier_round. The sweep is bottom-up only
# (level-synchronous pull over the shared candidate list); BFS distances
# are canonical, so row k is bit-equal to a single-source run from
# sources[k]. SYMMETRIC graphs only (module contract above).
#
# The K frontiers are vertex-major words (ops/frontier.py's module doc):
# Kp = min(next_pow2(K), 32) bits a vertex in each plane of 32 jobs, so a
# parent's test loads one word for all the jobs of a plane. At K = 1 they
# are the single-source bitmap. They never leave frontier_bfs_batched.
#
# Pads, as in the single-source path: dist is [K, n+2]; column n is never
# written and stays INF in both modes (dead candidates read it through
# the clamp v = min(cand, n)); column n+1 is a spare that absorbs the
# scatters JAX drops (its [K, n+1] dist has no column n+1). Nothing reads
# the spare: the words and the plan look at the first n+1 and n columns.


def _pack_bits_batched(dist, active, level: int, n_: int):
    """[G, plane_bytes(n_+2, K)] uint8 frontier words: bit k of vertex v
    in plane g = (dist[g*32 + k, v] == level and the job is active), the
    bits past n_ zero. An inactive job's bits are all zero, so no hit test
    can find anything for it. K shift-OR passes into an int32 word a
    vertex, plane by plane: no [K, n] int temporary."""
    K, dev = dist.shape[0], dist.device
    Kp, G = word_bits(K)
    nb = plane_bytes(n_ + 2, K)
    nv = nb * 8 // Kp                    # vertex slots in a plane, >= n_+2
    out = torch.empty((G, nb), dtype=torch.uint8, device=dev)
    for g in range(G):
        w = torch.zeros(nv, dtype=torch.int32, device=dev)
        for k in range(32 * g, min(K, 32 * g + 32)):
            w[:n_ + 1] |= ((dist[k, :n_ + 1] == level) & active[k]) \
                .to(torch.int32) << (k - 32 * g)
        if Kp >= 8:                      # little-endian: the low Kp/8 bytes
            out[g] = w.view(torch.uint8).view(nv, 4)[:, :Kp // 8].flatten()
        else:                            # 8/Kp vertices a byte
            sh = torch.arange(8 // Kp, dtype=torch.int32, device=dev) * Kp
            out[g] = (w.view(nb, 8 // Kp) << sh).sum(1).to(torch.uint8)
    return out


def _bit_of_batched(fbits, idx, K: int):
    """Test all K jobs' words at shared int32 indices: fbits [G, nb], idx
    [...] -> bool [K, *idx.shape]. Indices clamp into the planes as the
    kernels clamp them (``ops.frontier.words_at``)."""
    Kp, _ = word_bits(K)
    return job_bits(torch.stack([words_at(p, idx, Kp) for p in fbits]), K)


def _batched_plan(dist, active, level: int, degc, c_cap: int, n_: int,
                  expand: bool = False):
    """ONE n-scale pass serving all K jobs: the K jobs' frontier words,
    the SHARED candidate list (vertices unvisited in ANY active job, deg
    > 0; with ``expand``, hops mode, every vertex of deg > 0 while some
    job is active: the sweep then computes the exact next-hop set, so
    vertices stamped before are reached again), padded with n_+1, and
    ``stats`` = [candidate count, frontier count of each job] (int32).
    The [K, n] temporaries are bool."""
    fbits = _pack_bits_batched(dist, active, level, n_)
    d = dist[:, :n_]
    if expand:
        any_unvis = active.any().expand(n_)
    else:
        any_unvis = ((d >= INF) & active[:, None]).any(dim=0)
    nf = ((d == level) & active[:, None]).sum(dim=1, dtype=torch.int32)
    cand_mask = any_unvis & (degc[:n_] > 0)
    c_count, cand = compact_ids(cand_mask, c_cap, n_ + 1)
    return fbits, cand, torch.cat([c_count[None], nf])


def _stamp(gd, found, level: int, expand: bool):
    """Stamp ``level+1`` into the gathered dist columns ``gd`` [K, C]
    where ``found``, in place, with JAX's reductions: min (BFS) or max
    (hops). In BFS mode ``found`` implies undecided, so the entry is >=
    INF and the min is level+1: a plain masked store. In hops mode the
    entry is usually <= level, where the max is level+1, but a row seeded
    through ``init_dist`` may hold larger values, which the max keeps, so
    the store is masked by ``gd < level+1``. The columns a sweep writes
    back are distinct candidates (dead slots read and write back the
    untouched column n), so writing ``gd`` back with ``index_copy_`` is
    the scatter, with no [K, C] int64 index."""
    if expand:
        found = found & (gd < level + 1)
    gd.masked_fill_(found, level + 1)


def _batched_rounds(dist, fbits, cand, off, c_count, level: int, g,
                    tbits, fuse: int, expand: bool, live):
    """``fuse`` chunk rounds over the shared candidate list, each one
    ``frontier_round`` at K jobs: chunk ``off`` of each candidate is
    gathered once and tested against all K frontiers (slots set in
    ``tbits`` masked: the overlay's tombstones or a level's label mask);
    finds are stamped into dist; a candidate survives while it has chunks
    left and some job still has it undecided. In hops mode a candidate is
    undecided for every LIVE job (``live`` [K, 1] bool, None in BFS
    mode: a nonzero frontier count in the plan; a deactivated or pad row
    must never pin candidates through all their chunks) that has not
    stamped it this level. The survivor count stays on the device
    between rounds (``fuse`` >= 1, so the count returned is the
    kernel's). Returns ``(cand, off, prog)``, ``prog`` = [survivors,
    their remaining chunk mass] (int32). The one [K, C] int32 temporary
    is the dist gather; the rest are bool."""
    n_ = g["n"]
    dstT, colstart, degc = g["dstT"], g["colstart"], g["degc"]
    q_pad = dstT.shape[1] - 1
    slots = torch.arange(cand.shape[0], device=dist.device)
    for _ in range(fuse):
        alive = slots < c_count
        v = cand.clamp(max=n_).long()
        dv = degc[v]
        cols = torch.where(alive & (off < dv), colstart[v] + off, q_pad)
        gd = dist[:, v]                                  # [K, C] int32
        undec = ((gd != level + 1) & live) if expand else gd >= INF
        undec &= alive
        found, cand, off, c_count = frontier_round(
            cols, undec, alive & (off + 1 < dv), cand, off + 1, fbits,
            tbits, dstT, lanes=SPLIT_LANES, fill0=n_ + 1, fill1=0)
        del undec
        _stamp(gd, found, level, expand)
        dist.index_copy_(1, v, gd)
        del gd, found
    alive = slots < c_count
    v = cand.clamp(max=n_).long()
    rem = torch.where(alive, (degc[v] - off).clamp(min=0), 0) \
        .sum(dtype=torch.int32)
    return cand, off, torch.stack([c_count, rem])


def _batched_exhaust(dist, fbits, cand, off, c_count: int, level: int, g,
                     tbits, p_cap: int, expand: bool):
    """One sweep over ALL remaining chunks of the surviving candidates
    (hub stragglers), per-job any-hit folded by candidate
    (``ops.frontier.batched_exhaust``); slots set in ``tbits`` never hit.
    Hops mode stamps every found candidate (no undecided mask), as the
    JAX package does."""
    n_ = g["n"]
    dstT, colstart, degc = g["dstT"], g["colstart"], g["degc"]
    c_cap = cand.shape[0]
    valid = torch.arange(c_cap, device=dist.device) < c_count
    v = cand.clamp(max=n_).long()
    rem = (degc[v] - off).clamp(min=0)
    cols, p_total, owner = enumerate_chunk_pairs(
        valid, rem, colstart[v] + off, p_cap, dstT.shape[1] - 1,
        with_owner=True)
    found = batched_exhaust(cols, owner, p_total, fbits, tbits, dstT,
                            K=dist.shape[0], c_cap=c_cap) & valid
    del cols, owner
    gd = dist[:, v]
    if not expand:
        found &= gd >= INF
    _stamp(gd, found, level, expand)
    dist.index_copy_(1, v, gd)


def _overlay_scatter_batched(dist, fbits, ov_src, ov_dst, level: int,
                             n_: int, expand: bool = False):
    """The overlay's added edges, top-down: for every live add (u, v),
    the jobs whose frontier holds u scatter level+1 into v (min in BFS
    mode, max in hops mode, as the base sweep stamps). Pad entries (n_+1)
    miss every job and land in the spare column."""
    K = dist.shape[0]
    hit = _bit_of_batched(fbits, ov_src, K)              # [K, cap]
    idx = ov_dst.long().clamp(0, n_ + 1)[None, :].expand(K, -1)
    if expand:
        msg = torch.where(hit, level + 1, 0).to(torch.int32)
        dist.scatter_reduce_(1, idx, msg, reduce="amax")
    else:
        msg = torch.where(hit, level + 1, INF).to(torch.int32)
        dist.scatter_reduce_(1, idx, msg, reduce="amin")


def _initial_dist(K: int, n: int, src_arr, init_dist, expand: bool,
                  start_level: int, dev, lo: int = 0, hi: int | None = None):
    """The [K, w+2] state of vertices ``[lo, hi)`` (default all n, w = hi
    - lo): ``init_dist``'s columns with two INF columns appended, or the
    seeding of the JAX function (BFS: INF with each source at 0; hops: 0
    with each source at ``start_level`` and column w INF)."""
    hi = n if hi is None else hi
    w = hi - lo
    if init_dist is not None:
        d = init_dist[:, lo:hi]
        d = d.to(dev, torch.int32) if torch.is_tensor(d) \
            else torch.from_numpy(np.ascontiguousarray(d, np.int32)).to(dev)
        # column w is the never-written INF column of a fresh run, so a
        # resumed row appends it (and the spare)
        return torch.cat([d, torch.full((K, 2), INF, dtype=torch.int32,
                                        device=dev)], dim=1)
    mine = (src_arr >= lo) & (src_arr < hi)
    rows = torch.from_numpy(np.flatnonzero(mine)).to(dev)
    srcs = torch.from_numpy(src_arr[mine] - lo).to(dev)
    if expand:
        dist = torch.zeros((K, w + 2), dtype=torch.int32, device=dev)
        dist[rows, srcs] = start_level
        dist[:, w] = INF
    else:
        dist = torch.full((K, w + 2), INF, dtype=torch.int32, device=dev)
        dist[rows, srcs] = 0
    return dist


def _readback(ts) -> list:
    """Each tensor of ``ts`` as a list, every copy issued before any is
    read: a card's goes to pinned host memory behind its own stream, so
    the cards of a mesh never wait for one another's readback. One
    tensor is a plain ``.tolist()``."""
    if len(ts) == 1:
        return [ts[0].tolist()]
    staged = []
    for t in ts:
        if t.device.type != "cuda":
            staged.append((t, None))
            continue
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        staged.append((h, ev))
    for _, ev in staged:
        if ev is not None:
            ev.synchronize()
    return [h.tolist() for h, _ in staged]


class _Block:
    """One vertex block of a batched run: its chunked CSR ``g`` (``n`` =
    its width, ``colstart``/``degc`` re-based to it, ``dstT`` payload the
    global ids), its first vertex ``lo`` and first global column ``c0``,
    its ``[K, w+2]`` dist and this level's plan. A run on one device is
    one block: the whole graph at ``lo`` = 0."""

    def __init__(self, g: dict, lo: int, c0: int, dist):
        self.g, self.lo, self.c0, self.dist = g, lo, c0, dist
        self.w = g["n"]
        self.dev = dist.device
        self.cap = next_pow2(max(self.w, 2))
        self.active = None
        self.plan = None

    def slots(self, bits, dev=None):
        """A slot bitmap (byte = global chunk column, clamped as the
        kernels clamp it) cut to this block's columns, its pad column
        included, on this block's device."""
        q = self.g["dstT"].shape[1]
        idx = torch.arange(self.c0, self.c0 + q, device=bits.device) \
            .clamp_(max=bits.shape[0] - 1)
        return bits[idx].to(self.dev)


def _blocks(placed: dict, K: int, src_arr, init_dist, expand: bool,
            start_level: int) -> list:
    """The blocks of a mesh-placed graph (``place_batched_csr``)."""
    n = placed["n"]
    return [_Block(sh, sh["lo"], sh["c0"],
                   _initial_dist(K, n, src_arr, init_dist, expand,
                                 start_level, sh["device"], sh["lo"],
                                 sh["hi"]))
            for sh in placed["_shards"]]


class _Words:
    """The K jobs' frontier words of a level, whole, on each device of
    the run. One block's words are the whole (``lo`` = 0). Over several
    blocks each block packs its own and ``copy_`` puts them into a full
    ``[G, plane_bytes(n+2, K)]`` array on every device, ordered against
    both devices' current streams; a block starts on a multiple of 8
    vertices, so its words start on a byte."""

    def __init__(self, blocks: list, K: int, n: int):
        self.blocks, self.K = blocks, K
        Kp, G = word_bits(K)
        self.Kp = Kp
        self.full = {} if len(blocks) == 1 else {
            b.dev: torch.zeros((G, plane_bytes(n + 2, K)),
                               dtype=torch.uint8, device=b.dev)
            for b in blocks}
        #: bytes of words copied a level: in all, and between devices
        self.copied = {"bytes": [], "between_devices": []}

    def share(self) -> dict:
        """{device: words} from each block's plan."""
        if not self.full:
            b = self.blocks[0]
            return {b.dev: b.plan[0]}
        total = between = 0
        for b in self.blocks:
            a, ln = b.lo * self.Kp // 8, -(-b.w * self.Kp // 8)
            local = b.plan[0][:, :ln]
            for dev, full in self.full.items():
                full[:, a:a + ln].copy_(local, non_blocking=True)
                total += local.numel()
                between += local.numel() if dev != b.dev else 0
        self.copied["bytes"].append(total)
        self.copied["between_devices"].append(between)
        return self.full


def _overlay_adds(ov, blocks: list) -> list:
    """Each block's overlay adds ``(src, dst)``: the adds whose
    destination it owns, ``dst`` re-based to it and ``src`` global, on
    its device. One block takes the view's arrays as they are (pads n+1
    land in its spare column)."""
    if len(blocks) == 1:
        return [(ov.src_dev, ov.dst_dev)]
    src = ov.src_dev.cpu().numpy()
    dst = ov.dst_dev.cpu().numpy()
    out = []
    for b in blocks:
        mine = (dst >= b.lo) & (dst < b.lo + b.w)
        out.append((torch.from_numpy(src[mine]).to(b.dev),
                    torch.from_numpy(dst[mine] - b.lo).to(b.dev)))
    return out


def _gather_dist(blocks: list, n: int, cols: int):
    """The first ``cols`` (n or n+1) columns of the run's dist, whole on
    the first block's device (column n is INF), as a tensor of its own."""
    b0 = blocks[0]
    if len(blocks) == 1:
        return b0.dist[:, :cols].clone()
    parts = [b.dist[:, :b.w].to(b0.dev) for b in blocks]
    if cols > n:
        parts.append(torch.full((b0.dist.shape[0], cols - n), INF,
                                dtype=torch.int32, device=b0.dev))
    return torch.cat(parts, dim=1)


#: the frontier words the last run copied level by level: ``bytes`` in
#: all, ``between_devices`` of them (both empty after a run on one block)
LAST_WORDS_COPIED: dict = {"bytes": [], "between_devices": []}


def frontier_bfs_batched(snap_or_graph, sources, max_levels: int = 1000,
                         on_level=None, return_device: bool = False,
                         init_dist=None, start_level: int = 0,
                         checkpoint=None, overlay=None, mode: str = "bfs",
                         level_masks=None, device=None):
    """Batched multi-source BFS: K BFS jobs over the SAME graph as one
    run with [K, n] state. Each job's ``dist`` row is bit-equal to
    ``frontier_bfs_hybrid`` from that source; the per-level plan and
    every edge-chunk gather are shared across jobs. ``snap_or_graph`` is
    a snapshot (duck-typed, see ``build_chunked_csr``), a device graph
    dict on ``device`` (``None`` means CUDA), or a mesh-placed graph
    (below).

    ``on_level(level, frontier_counts)``: an optional host callback after
    each level's plan, given the per-job frontier sizes (np int32 [K]);
    it may return a boolean KEEP mask [K]: jobs masked out stop before
    the level's sweep and report ``completed=False``. None keeps all.

    Checkpoints: the level-synchronous state is ``(dist, level)`` (the
    frontier is ``dist == level``), so ``checkpoint(level, dist,
    active)`` at a level boundary (dist a [K, n+1] device tensor of its
    own, active np bool [K]) captures everything, and ``init_dist`` ([K,
    n] int32) with ``start_level`` resumes bit-equal (``sources`` then
    only sizes and validates the batch). The JAX package hands the
    callback an immutable array; ``dist`` is updated in place here, so
    the callback gets a copy.

    Live overlay: ``overlay``, an ``OverlayView`` (default: the
    snapshot's ``_live_overlay``), makes the run overlay-aware:
    tombstoned base slots stop counting as parents in the bottom-up hit
    tests, and a per-level scatter pass expands the overlay's added
    edges; the result is bit-equal to a rebuilt snapshot.

    Hops mode (``mode="hops"``, the interactive lane's ``out()*h``): the
    same plan and sweep compute exact per-hop frontier SETS: no visited
    mask, so a vertex reached at hop h is reached again at a later hop
    when a path exists. dist[k, v] = the LAST loop level at which v was
    in job k's frontier (``level + 1`` stamped by max; 0 = never), so the
    hop-d set of a job deactivated after its depth through ``on_level``
    is ``dist == d + start_level``. Needs ``start_level >= 1`` and seeds
    stamped ``start_level`` in ``init_dist`` (or through ``sources``).

    ``level_masks``: per-level edge-slot bitmaps (uint8 tensors, the
    overlay tombstone packing: byte = chunk column, bit = lane; 1 = the
    slot does not count as a parent this level), indexed ``level -
    start_level``; None entries and levels past the list run unmasked.
    They ride the kernel's ``tbits`` seam, so they are refused together
    with a non-empty overlay (ValueError).

    Mesh placement: a graph dict with ``_state_sharding``
    (``parallel/partition.place_batched_csr``) runs block by block on
    its mesh's devices, each level in lockstep: each block plans its own
    vertices (its K jobs' words and candidates), the words are copied
    into a whole array on every device (``LAST_WORDS_COPIED``), each
    block runs ``frontier_round`` and ``batched_exhaust`` over its own
    columns and stamps its own dist, and the host reads one stats and
    one progress readback a block, all issued before any is read, and
    sums them. Slot bitmaps are cut to each block's columns; an overlay's
    adds scatter on the block that owns their destination. ``device``
    must then be of the mesh's devices' type; ``checkpoint`` gets the
    dist gathered on the mesh's first device, and the result is
    gathered there.

    Stages (``obs/devprof`` seams on ``device``'s stream): each plan,
    re-plans included, with its stats readback is
    ``bfs_batched.plan``; each level from the words' share through the
    rounds, the progress readback and the stragglers' sweep is
    ``bfs_batched.sweep`` (``frontier_round`` and ``batched_exhaust``
    inside it); the final ``[K, n]`` copy to the host is
    ``bfs_batched.readback`` (none with ``return_device``).

    Returns ``(dist, levels, completed)``: dist [K, n] int32 (a device
    tensor when ``return_device``, else numpy; INF = unreachable, partial
    for jobs not completed), levels np int32 [K] (the level at which each
    job's frontier emptied or it was dropped), completed np bool [K]."""
    dev = resolve_device(device)
    meshed = isinstance(snap_or_graph, dict) \
        and "_state_sharding" in snap_or_graph
    g = snap_or_graph if isinstance(snap_or_graph, dict) \
        else build_chunked_csr(snap_or_graph, dev)
    if meshed and not g.get("_shards"):
        raise ValueError("a graph dict with _state_sharding must come from "
                         "parallel.partition.place_batched_csr")
    g_dev = g["_shards"][0]["device"] if meshed else g["dstT"].device
    if g_dev.type != dev.type:
        raise ValueError(f"graph lies on {g_dev}, device={dev}")
    ov = overlay
    if ov is None and not isinstance(snap_or_graph, dict):
        ov = getattr(snap_or_graph, "_live_overlay", None)
    if ov is not None and ov.empty:
        ov = None
    if level_masks is not None and ov is not None:
        raise ValueError(
            "level_masks under a live overlay is unsupported (overlay "
            "add-edges carry labels the slot mask cannot filter); compact "
            "the overlay first")
    if ov is not None and ov.tomb_dev.device.type != dev.type:
        raise ValueError(f"overlay lies on {ov.tomb_dev.device}, "
                         f"device={dev}")
    if mode not in ("bfs", "hops"):
        raise ValueError(f"mode must be 'bfs' or 'hops', got {mode!r}")
    expand = mode == "hops"
    if expand and start_level < 1:
        raise ValueError("hops mode needs start_level >= 1 (0 is the "
                         "never-reached background value)")
    K = len(sources)
    if K == 0:
        raise ValueError("frontier_bfs_batched needs >= 1 source")
    src_arr = np.asarray(sources, np.int64)
    n = g["n"]
    if src_arr.min() < 0 or src_arr.max() >= n:
        raise IndexError(f"source out of range [0, {n})")
    if init_dist is not None:
        if not torch.is_tensor(init_dist):
            init_dist = np.asarray(init_dist, np.int32)
        if tuple(init_dist.shape) != (K, n):
            raise ValueError(f"init_dist must be [K={K}, n={n}], got "
                             f"{tuple(init_dist.shape)}")
    if meshed:
        blocks = _blocks(g, K, src_arr, init_dist, expand, start_level)
    else:
        blocks = [_Block(g, 0, 0, _initial_dist(
            K, n, src_arr, init_dist, expand, start_level,
            g["dstT"].device))]
    one = len(blocks) == 1
    tbits = None
    if ov is not None and ov.tomb_count > 0:
        tbits = [ov.tomb_dev] if one else [b.slots(ov.tomb_dev)
                                           for b in blocks]
    adds = _overlay_adds(ov, blocks) if ov is not None and ov.count > 0 \
        else None
    words = _Words(blocks, K, n)

    def plan_all():
        with devprof.seam("bfs_batched.plan", dev):
            for b in blocks:
                b.plan = _batched_plan(b.dist, b.active, level, b.g["degc"],
                                       b.cap, b.w, expand)
            sts = _readback([b.plan[2] for b in blocks])
        return [st[0] for st in sts], \
            np.sum([st[1:] for st in sts], axis=0, dtype=np.int32)

    act_h = np.ones(K, bool)
    for b in blocks:
        b.active = torch.from_numpy(act_h).to(b.dev)
    levels = np.zeros(K, np.int32)
    completed = np.zeros(K, bool)
    level = int(start_level)
    while level < max_levels:
        c_counts, nf = plan_all()        # ONE readback a level a block
        mask_changed = False
        # an empty frontier means that job's BFS is complete
        newly_done = act_h & (nf == 0)
        if newly_done.any():
            completed[newly_done] = True
            levels[newly_done] = level
            act_h = act_h & ~newly_done
            mask_changed = True
        if on_level is not None and act_h.any():
            keep = on_level(level, nf.copy())
            if keep is not None:
                dropped = act_h & ~np.asarray(keep, bool)
                if dropped.any():
                    levels[dropped] = level
                    act_h = act_h & ~dropped
                    mask_changed = True
        if not act_h.any():
            break
        if checkpoint is not None:
            # a consistent boundary: every level < ``level`` is final in
            # dist; this level's frontier (dist == level) is unswept
            checkpoint(level, _gather_dist(blocks, n, n + 1), act_h.copy())
        if mask_changed:
            # deactivated jobs must stop influencing the sweep: re-plan
            # with the new mask, which zeroes their frontier bits and drops
            # their unvisited sets from the shared candidate list
            for b in blocks:
                b.active = torch.from_numpy(act_h).to(b.dev)
            c_counts, nf = plan_all()
        with devprof.seam("bfs_batched.sweep", dev):
            fbits = words.share()
            # hops mode: the jobs with a frontier this level, from the
            # plan's per-job counts (column w of a block is never ==
            # level): on the device for one block, summed on the host
            # over several
            live = None
            if expand:
                live = (blocks[0].plan[2][1:] > 0)[:, None] if one \
                    else torch.from_numpy(nf > 0)[:, None]
            # a level's label mask rides the tbits seam of the tombstones
            tb_l = tbits
            if level_masks is not None:
                i_lm = level - start_level
                lm = level_masks[i_lm] \
                    if 0 <= i_lm < len(level_masks) else None
                if lm is not None:
                    tb_l = [lm] if one else [b.slots(lm) for b in blocks]
            progs = []
            for i, (b, c_count) in enumerate(zip(blocks, c_counts)):
                fb = fbits[b.dev]
                if adds is not None:
                    # overlay adds expand top-down off the level's final
                    # words, independent of the base sweep below (both
                    # stamp level+1 by the same reduction, so the order
                    # does not matter); it runs even when the base
                    # candidate list is empty
                    _overlay_scatter_batched(b.dist, fb, adds[i][0],
                                             adds[i][1], level, b.w, expand)
                if c_count > 0:
                    # BU_CHUNK_ROUNDS chunk rounds over the block's candidates
                    c_cap2 = min(next_pow2(max(c_count, 2)), b.cap)
                    off = torch.zeros(c_cap2, dtype=torch.int32, device=b.dev)
                    cand, off, prog = _batched_rounds(
                        b.dist, fb, b.plan[1][:c_cap2], off, c_count, level,
                        b.g, None if tb_l is None else tb_l[i],
                        BU_CHUNK_ROUNDS, expand,
                        None if live is None else live.to(b.dev))
                    progs.append((i, cand, off, prog))
            done = _readback([p[3] for p in progs])   # ONE a block a fuse
            for (i, cand, off, _), (c_count, rem8) in zip(progs, done):
                if c_count > 0:
                    # the stragglers' remaining chunks, all in one sweep
                    b = blocks[i]
                    c_cap2 = min(next_pow2(max(c_count, 2)), b.cap)
                    _batched_exhaust(b.dist, fbits[b.dev], cand[:c_cap2],
                                     off[:c_cap2], c_count, level, b.g,
                                     None if tb_l is None else tb_l[i],
                                     next_pow2(max(rem8, 2)), expand)
        level += 1
    # jobs still active at max_levels count as completed at the cap
    if act_h.any():
        completed[act_h] = True
        levels[act_h] = level
    LAST_WORDS_COPIED.update(words.copied)
    out = blocks[0].dist[:, :n] if one else _gather_dist(blocks, n, n)
    if return_device:
        return out, levels, completed
    with devprof.seam("bfs_batched.readback", dev):
        devprof.count_d2h("bfs.dist", out.numel() * out.element_size())
        host = out.cpu().numpy()
    return host, levels, completed
