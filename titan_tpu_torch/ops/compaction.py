"""Stream-compaction primitives for the BFS and frontier round loops
(port of ``titan_tpu/ops/compaction.py``).

Contract, as in the JAX package: survivors keep ascending input order,
slots past the survivor count hold the fill value, survivors past
``cap`` are dropped, and ``count`` is the TOTAL number of set mask bits
(it may exceed ``cap``). Counts and cumsums stay int32.

JAX drops an out-of-range scatter index (``mode="drop"``) where PyTorch
raises, so every scatter here sends a dropped lane to a spare slot past
the end of a ``cap + 1`` buffer (or turns it into a no-op of the
reduction) and nothing reads that slot. Nothing here synchronises with
the device: counts are returned as 0-d tensors.

The claim primitives update the claim array IN PLACE (the JAX versions
return a new array); every op stays keys-scale.
"""

from __future__ import annotations

import torch

CLAIM_SENTINEL = 2**31 - 1
_INT32_MIN = -2**31


def scatter_compact(mask, payloads, cap: int, fills):
    """Compact each payload [L] by ``mask`` [L] bool into ``cap``-sized
    outputs through ONE shared target index. Returns ``(count, outs)``."""
    cs = torch.cumsum(mask, 0, dtype=torch.int32)
    count = cs[-1]
    tgt = torch.where(mask & (cs <= cap), cs - 1, cap).long()
    outs = []
    for p, fill in zip(payloads, fills):
        out = torch.full((cap + 1,), fill, dtype=p.dtype, device=p.device)
        out.index_put_((tgt,), p)
        outs.append(out[:cap])
    return count, tuple(outs)


def compact_ids(mask, cap: int, fill):
    """Ascending int32 index list of ``mask``'s set positions, ``fill``
    past the count. Returns ``(count, ids)``."""
    ids = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    count, (out,) = scatter_compact(mask, (ids,), cap, (fill,))
    return count, out


def _valid_keys(claim, keys):
    return (keys >= 0) & (keys < claim.shape[0])


def claim_dedup(claim, keys, ticket):
    """Among all lanes presenting the same key, exactly one wins: the
    minimum ``ticket``. Applies the claims to ``claim`` in place and
    returns ``(claim, winner)``, ``winner`` shaped like ``keys``.
    Out-of-range keys never claim and never win: they scatter
    ``CLAIM_SENTINEL`` into slot 0, which no claim value exceeds.

    The claim array must hold ``CLAIM_SENTINEL`` at every key this call
    touches (the virgin state, or what ``claim_reset`` restores)."""
    ok = _valid_keys(claim, keys)
    idx = torch.where(ok, keys, 0).reshape(-1).long()
    tick = torch.where(ok, ticket, CLAIM_SENTINEL).reshape(-1)
    claim.scatter_reduce_(0, idx, tick.to(claim.dtype), reduce="amin")
    won = (claim[idx].reshape(keys.shape) == ticket) & ok
    return claim, won


def claim_reset(claim, keys):
    """Restore ``CLAIM_SENTINEL`` at every position ``keys`` touched, in
    place. The sentinel is int32's maximum, so a max-scatter of it is a
    set; out-of-range keys scatter int32's minimum into slot 0, a
    no-op."""
    ok = _valid_keys(claim, keys)
    idx = torch.where(ok, keys, 0).reshape(-1).long()
    val = torch.where(ok, CLAIM_SENTINEL, _INT32_MIN).reshape(-1)
    claim.scatter_reduce_(0, idx, val.to(claim.dtype), reduce="amax")
    return claim


def banded_frontier(mask, mass, cap: int, k_max: int, budget: int, fill):
    """Band extraction for the priority-batched frontier schedulers:
    compact the member ids AND their per-member masses through one shared
    index, then cut the listed mass into ~``budget``-sized segments.

    ``mask`` [L] selects the band, ``mass`` [L] (nonnegative int32, read
    elementwise) is each item's chunk count. Returns ``(nf, m8, overflow,
    flist, bounds)``: ``nf`` listed members (min(count, cap)), ``m8``
    their total mass (int32), ``overflow`` 1 iff some prefix of the
    listed mass exceeds int32 (the segment bounds are then unusable and
    the caller must refuse the round), ``flist`` [cap] member ids
    ascending (``fill`` past nf), ``bounds`` [k_max+1] list positions such
    that segment k = flist[bounds[k]:bounds[k+1]] carries ~budget mass (a
    straddling member lands wholly in its segment).

    The cumsum runs in int64. The JAX package accumulates in int32 with
    x64 off and detects the wrap (nonnegative masses make the first wrap
    land negative), which flags exactly the same inputs; without overflow
    every output is the same, ``m8`` included."""
    ids = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    count, (flist, mlist) = scatter_compact(mask, (ids, mass), cap,
                                            (fill, 0))
    nf = torch.clamp(count, max=cap)
    cmass = torch.cumsum(mlist, 0)                   # int64 for int32 in
    total = cmass[-1]
    overflow = (total > 2**31 - 1).to(torch.int32)   # prefixes only grow
    m8 = torch.clamp(total, max=2**31 - 1).to(torch.int32)
    targets = torch.arange(1, k_max + 1, dtype=torch.int64,
                           device=mask.device) * budget
    bounds = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=mask.device),
        torch.clamp(torch.searchsorted(cmass, targets, right=True),
                    max=cap).to(torch.int32)])
    return nf, m8, overflow, flist, bounds
