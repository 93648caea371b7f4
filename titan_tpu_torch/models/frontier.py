"""Frontier-sparse SSSP and connected components, and the dense-window
PageRank, on the chunked CSR (port of ``titan_tpu/models/frontier.py``).

* ``frontier_sssp``: expansion-tracked SSSP over hashed edge weights.
  ``val_exp`` records the value each vertex last pushed, so the frontier
  is the set ``val < val_exp`` and a round cut short resumes exactly.
  Each round is one plan (``_band_plan``: the in-band list, its
  mass-balanced segment bounds and four stats read back with ONE
  ``.tolist()``) and one push per segment (``_push_list``). The band is
  every improved vertex (plain), a delta-stepping bucket (``delta``), or
  a device-computed threshold carrying ~``quantile_mass`` chunks (the
  default).
* ``frontier_wcc``: one direction-optimizing BFS (``frontier_bfs_hybrid``,
  whose bottom-up rounds run the ``frontier_round`` kernel) peels the
  max-degree vertex's component, then min-label propagation runs over
  the rest with the same round loop.
* ``frontier_sssp_batched`` / ``frontier_wcc_batched``: K members over
  one shared round loop, all K plans read back with one ``.tolist()``.
* ``pagerank_dense``: push-mode PageRank by column windows; the
  personalized batch is ``models/pagerank.pagerank_personalized_batched``.

None of this has a Pallas kernel in the JAX package (its scatters and
gathers are XLA), so it is plain PyTorch here. JAX semantics kept by
hand:

* Value arrays are ``[n + 1 + SPARE]``: index n is the sink (never
  written, as in JAX), and the ``SPARE`` slots past it absorb the
  scatters JAX drops (``mode="drop"``: pad lanes n+1, tombstoned lanes,
  lanes that do not fit). A pad lane of column c lands in slot
  ``n + 1 + c % SPARE``, so on a card the pads of a block do not all
  contend for one address. Nothing reads the spare slots; checkpoint
  states and ``resume`` carry the JAX shape ``[n+1]``.
* JAX arrays are immutable and donated; here ``val``/``val_exp`` are
  updated in place, so a checkpoint callback gets copies, and every
  cohort member owns its tensors.
* Edge weights hash the low 32 bits of the slot id ``col*8 + lane``
  (computed in int64: JAX's int32 slot wraps, and its ``uint32`` cast
  keeps exactly these bits). XLA contracts ``min_w + w_range * u`` into
  one fused multiply-add; the port rounds once through float64, which
  gives the same float32 (``_hash_weight_expr``).
* Tombstones are tested by byte = column, bit = lane
  (``ops/frontier.slot_open``), never through an int32 slot id.
* Counts stay int32; the listed-mass cumsum runs in int64
  (``ops/compaction.banded_frontier``) and flags what JAX's int32 wrap
  flags.

Entry points take ``device=None``, which means CUDA and raises without a
card; a graph dict must lie on that device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from titan_tpu_torch.device import INF, next_pow2, resolve_device
from titan_tpu_torch.models.bfs_hybrid import (build_chunked_csr,
                                               enumerate_chunk_pairs,
                                               frontier_bfs_hybrid)
from titan_tpu_torch.ops.compaction import banded_frontier
from titan_tpu_torch.ops.frontier import slot_open

FINF = np.float32(3.0e38)
IINF = np.int32(1 << 30)

#: per-slice chunk budget: a push works on [8, p_cap] blocks with p_cap at
#: most the next power of two over this (see ``_budget``)
SLICE_BUDGET_CHUNKS = 1 << 23
#: segments a round at most; the rest of an over-full band waits a round
SLICE_K_MAX = 64
#: PageRank column window
DENSE_WINDOW = 1 << 22
#: in-band list width of the quantile mode (truncation only defers)
QUANT_LIST_CAP = 1 << 23
#: default band mass (chunks) of the quantile-batched SSSP
QUANTILE_MASS_DEFAULT = 1 << 24
#: scatter slots past the sink (see the module doc)
SPARE = 1 << 10

_M32 = 0xFFFFFFFF


class RoundInterrupted(Exception):
    """Raised out of the round loops when the caller's ``on_round``
    callback vetoes continuing (the serving layer's cancellation)."""

    def __init__(self, rounds: int):
        super().__init__(f"interrupted after {rounds} rounds")
        self.rounds = rounds


# --------------------------------------------------------------------------
# edge weights
# --------------------------------------------------------------------------

def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit
    constant, multiplied by its 16-bit halves so no int64 product
    overflows."""
    return ((((x * (c >> 16)) & 0xFFFF) << 16) + x * (c & 0xFFFF)) & _M32


def _hash_weight_expr(slot, min_w: float, w_range: float):
    """Uniform [min_w, min_w + w_range) float32 weights of int64 slot
    ids: the murmur-style mix of the low 32 bits, as the JAX package
    hashes them. ``min_w`` and ``w_range`` are rounded to float32 first
    (JAX ships them as a float32 array); the last step is one rounding
    of ``w_range * u + min_w`` (exact in float64: both factors have 24
    significant bits), the fused multiply-add XLA emits."""
    x = slot & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    u = (x & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    return (u.to(torch.float64) * float(np.float32(w_range))
            + float(np.float32(min_w))).to(torch.float32)


def slot_weights_np(slots: np.ndarray, min_w: float = 0.0,
                    w_range: float = 1.0) -> np.ndarray:
    """The JAX package's numpy weight oracle, copied: the same hash, but
    ``min_w + w_range * u`` rounded twice. Equal to the device weights for
    the defaults (0, 1)."""
    x = slots.astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    x = x ^ (x >> np.uint32(16))
    u = (x & np.uint32(0xFFFFFF)).astype(np.float32) / np.float32(1 << 24)
    return (min_w + w_range * u).astype(np.float32)


# --------------------------------------------------------------------------
# graph helpers
# --------------------------------------------------------------------------

def _graph(snap_or_graph, dev) -> dict:
    g = snap_or_graph if isinstance(snap_or_graph, dict) \
        else build_chunked_csr(snap_or_graph, dev)
    if g["dstT"].device.type != dev.type:
        raise ValueError(f"graph lies on {g['dstT'].device}, device={dev}")
    return g


def _overlay_of(snap_or_graph, overlay):
    """The explicit view, else the snapshot's attached one; None when
    empty."""
    ov = overlay
    if ov is None and not isinstance(snap_or_graph, dict):
        ov = getattr(snap_or_graph, "_live_overlay", None)
    return None if ov is None or ov.empty else ov


def _colowner(g):
    """Column -> owning vertex (int32 [q_total]; the sink column owns n),
    cached in the graph dict."""
    co = g.get("colowner")
    if co is None:
        n, degc = g["n"], g["degc"]
        ids = torch.arange(n + 1, dtype=torch.int32, device=degc.device)
        owner = torch.repeat_interleave(ids, degc.long(),
                                        output_size=g["q_total"] - 1)
        co = torch.cat([owner, ids.new_full((1,), n)])
        g["colowner"] = co
    return co


def _max_degc(g) -> int:
    got = g.get("_max_degc")
    if got is None:
        got = int(g["degc"].max())
        g["_max_degc"] = got
    return got


def _quantize_cap(mass: int, p_full: int) -> int:
    """A slice's kernel width: the next power of FOUR over ``mass``,
    capped at p_full (the JAX package's compile buckets; kept so every
    width choice, and so every round, is the same)."""
    c = next_pow2(max(mass, 2))
    if (c.bit_length() - 1) % 2:
        c <<= 1
    return min(c, p_full)


def _budget(max_dc: int) -> tuple[int, int]:
    """(segment mass budget, full kernel width): the budget is shaved by
    the largest vertex so a full segment fits a power-of-two width."""
    target = next_pow2(max(SLICE_BUDGET_CHUNKS, 2))
    if max_dc <= target // 2:
        return target - max_dc, target
    return SLICE_BUDGET_CHUNKS, next_pow2(max(SLICE_BUDGET_CHUNKS + max_dc,
                                              2))


def _targets(idx, n_: int, cols):
    """int64 scatter targets: real vertices as they are, anything past n
    (pads, masked lanes) into the spare slots by column."""
    spare = (n_ + 1) + (cols.long() & (SPARE - 1))
    return torch.where(idx <= n_, idx.long(), spare)


def _with_spare(head, fill):
    """[n+1] state (tensor or array) -> the [n+1+SPARE] working copy."""
    return torch.cat([head, head.new_full((SPARE,), fill)])


def _sync(t) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


# --------------------------------------------------------------------------
# the round: plan, pushes, overlay relax
# --------------------------------------------------------------------------

def _mass_hist(b, mass, sel, bins: int):
    """int32 [bins] sums of ``mass`` by bin ``b`` over the ``sel`` entries
    (JAX scatter-adds every entry, the unselected with mass 0 into the
    last bin: at scale 26 those 2^26 atomic adds onto one address took
    42-50 ms a histogram on an H100 against under 1 ms for this form,
    ``scripts/torch_frontier_breakdown.py``). ``bincount`` over the
    selected entries only; its float64 sums of int32 masses are exact."""
    idx = torch.nonzero(sel).squeeze(1)
    return torch.bincount(b[idx], weights=mass[idx].to(torch.float64),
                          minlength=bins).to(torch.int32)


def _band_plan(val, val_exp, degc, bucket_end, n_: int, f_cap: int,
               k_max: int, budget: int, quantile_mass: int, bins: int = 512):
    """The round plan for every scheduler mode: the membership mask, the
    band threshold (``bucket_end``, or with ``quantile_mass`` > 0 a
    two-level histogram threshold carrying ~that much chunk mass, float32
    only), the compacted in-band list with its segment bounds
    (``banded_frontier``), and the least value parked above the band.
    Every float expression keeps the JAX package's order of operations,
    so the thresholds, and hence the rounds, are the same. Returns
    ``(stats, flist, bounds, thr)``: stats int32 [nf, m8, overflow, pmin]
    with a float pmin bit-cast into int32."""
    is_f32 = val.dtype == torch.float32
    dev = val.device
    v = val[:n_]
    dc = degc[:n_]
    changed = (v < val_exp[:n_]) & (dc > 0)
    big_ = torch.tensor(FINF if is_f32 else IINF, dtype=val.dtype,
                        device=dev)
    if quantile_mass:
        # two-level histogram: the straddling bin is histogrammed again
        lo = torch.where(changed, v, big_).min()
        hi0 = torch.where(changed, v, -big_).max()
        span = torch.clamp(hi0 - lo, min=1e-30)
        b = ((v - lo) / span * bins).to(torch.int32).clamp(0, bins - 1)
        cum = torch.cumsum(_mass_hist(b, dc, changed, bins), 0,
                           dtype=torch.int32)
        qm = torch.tensor([quantile_mass], dtype=torch.int32, device=dev)
        pick = torch.clamp(torch.searchsorted(cum, qm), max=bins - 1)[0]
        lo2 = lo + span * pick.to(val.dtype) / bins
        span2 = span / bins
        before = torch.where(pick > 0, cum[torch.clamp(pick - 1, min=0)], 0)
        in2 = changed & (b == pick)
        b2 = ((v - lo2) / span2 * bins).to(torch.int32).clamp(0, bins - 1)
        cum2 = torch.cumsum(_mass_hist(b2, dc, in2, bins), 0,
                            dtype=torch.int32)
        pick2 = torch.clamp(torch.searchsorted(
            cum2, qm - before), max=bins - 1)[0]
        thr = lo2 + span2 * (pick2 + 1).to(val.dtype) / bins
        thr = torch.maximum(thr, torch.nextafter(lo, big_))
    else:
        thr = torch.tensor(bucket_end, dtype=val.dtype, device=dev)
    inb = changed & (v < thr)
    nf, m8, overflow, flist, bounds = banded_frontier(inb, dc, f_cap, k_max,
                                                      budget, n_)
    # improved vertices parked above the band: their minimum is where the
    # next delta bucket starts
    pmin = torch.where(changed & ~inb, v, big_).min()
    if is_f32:
        pmin = pmin.view(torch.int32)
    stats = torch.stack([nf, m8, overflow, pmin])
    return stats, flist, bounds, thr


def _push_list(kind: str, val, val_exp, flist, bounds, i: int, thr, dstT,
               colstart, degc, wparams, tbits, f_cap: int, p_cap: int,
               n_: int) -> None:
    """Push segment ``i`` of the round's in-band list, in place. Membership
    is rechecked live (an earlier segment may have improved a member; it
    pushes its current value). Only members whose whole chunk range fits
    ``p_cap`` are marked expanded; the rest stay improved for the next
    round. Then a min-scatter of every member's message to its
    neighbours (tombstoned slots masked)."""
    dev = val.device
    p0, p1 = bounds[i], bounds[i + 1]
    L = flist.shape[0]
    s0 = torch.clamp(p0, 0, max(L - f_cap, 0))
    pos = s0 + torch.arange(f_cap, dtype=torch.int32, device=dev)
    seg = flist[pos.long()]
    v = torch.clamp(seg, max=n_)
    vl = v.long()
    valv = val[vl]
    member = (pos >= p0) & (pos < p1) & (seg < n_) \
        & (valv < val_exp[vl]) & (valv < thr)
    counts = torch.where(member, degc[vl], 0)
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    fits = member & (ends <= p_cap)
    val_exp[torch.where(fits, vl, n_ + 1)] = valv
    cols, _, owner = enumerate_chunk_pairs(fits, counts, colstart[vl], p_cap,
                                           dstT.shape[1] - 1,
                                           with_owner=True)
    src_val = valv[owner.long()]
    cl = cols.long()
    nbr = dstT[:, cl]                                    # [8, p_cap]
    if tbits is not None:
        # live-overlay tombstones: a dead base slot relaxes nothing
        nbr = torch.where(slot_open(tbits, cols), nbr, n_ + 1)
    if kind == "sssp":
        lane = torch.arange(8, dtype=torch.int64, device=dev)[:, None]
        msg = src_val[None, :] + _hash_weight_expr(cl[None, :] * 8 + lane,
                                                   *wparams)
    else:
        msg = src_val[None, :].expand(8, -1)
    val.scatter_reduce_(0, _targets(nbr, n_, cols[None, :]).reshape(-1),
                        msg.reshape(-1), reduce="amin")


def _overlay_relax(kind: str, val, ov, wparams, n_: int):
    """Relax every live overlay add-edge with its source's current value,
    in place; returns the number of lanes that improve their target
    (int32 0-d, counted before the scatter). Overlay slots are
    ``slot_base + i``, hashed like base slots."""
    dev = val.device
    src_val = val[torch.clamp(ov.src_dev, max=n_).long()]
    if kind == "sssp":
        slot = ov.slot_base + torch.arange(ov.cap, dtype=torch.int64,
                                           device=dev)
        msg = src_val + _hash_weight_expr(slot, *wparams)
    else:
        msg = src_val
    nimp = (msg < val[torch.clamp(ov.dst_dev, max=n_).long()]) \
        .sum(dtype=torch.int32)
    val.scatter_reduce_(0, _targets(ov.dst_dev, n_, torch.arange(
        ov.cap, device=dev)), msg, reduce="amin")
    return nimp


def _stats_host(st, is_f32: bool):
    """(nf, m8, overflow, pmin) from one plan's host stats."""
    pm = np.array([st[3]], np.int32)
    return int(st[0]), int(st[1]), int(st[2]), \
        (pm.view(np.float32)[0] if is_f32 else pm[0])


def _refuse_overflow(kind: str):
    return RuntimeError(
        f"frontier_{kind}: banded_frontier's listed chunk mass overflowed "
        "int32; the segment bounds are unusable")


class _Round:
    """What every round of one run shares: the graph arrays, the overlay
    seams and the width choices (JAX's ``_frontier_run`` locals)."""

    def __init__(self, g, kind: str, wparams, is_f32: bool, ov):
        self.g, self.kind, self.n = g, kind, g["n"]
        self.is_f32 = is_f32
        self.big = float(FINF) if is_f32 else int(IINF)
        self.ov = ov
        self.tbits = ov.tomb_dev if ov is not None and ov.tomb_count > 0 \
            else None
        self.has_adds = ov is not None and ov.count > 0
        self.max_dc = _max_degc(g)
        # the in-band list never usefully exceeds the vertex count
        self.w_max = 1 << ((self.n + 1).bit_length() - 1)
        self.budget, self.p_full = _budget(self.max_dc)
        self.wp = (float(np.float32(wparams[0])),
                   float(np.float32(wparams[1])))

    def relax(self, val):
        return _overlay_relax(self.kind, val, self.ov, self.wp, self.n)

    def qf_cap(self, quantile_mass: int) -> int:
        return min(QUANT_LIST_CAP, self.w_max) if quantile_mass \
            else self.w_max

    def plan(self, val, val_exp, bucket_end, quantile_mass: int):
        qf_cap = self.qf_cap(quantile_mass)
        stats, flist, bounds, thr = _band_plan(
            val, val_exp, self.g["degc"], bucket_end, self.n, qf_cap,
            SLICE_K_MAX, self.budget, quantile_mass)
        return qf_cap, stats, flist, bounds, thr

    def push(self, val, val_exp, nf: int, m8: int, escalate: bool,
             qf_cap: int, flist, bounds, thr) -> None:
        """Every segment of a planned round, then one overlay hop."""
        g, budget, p_full = self.g, self.budget, self.p_full
        nseg = min(-(-m8 // budget), SLICE_K_MAX)
        f_bucket = _quantize_cap(min(nf, budget + self.max_dc), qf_cap)
        for k in range(nseg):
            # +max_dc: a vertex straddling the mass target lands wholly in
            # one segment
            mass_k = min(budget, m8 - k * budget) + self.max_dc
            p_cap = p_full if escalate else _quantize_cap(mass_k, p_full)
            fk = min(qf_cap, p_full) if escalate else min(f_bucket, p_cap)
            _push_list(self.kind, val, val_exp, flist, bounds, k, thr,
                       g["dstT"], g["colstart"], g["degc"], self.wp,
                       self.tbits, fk, p_cap, self.n)
        if self.has_adds:
            self.relax(val)


def _state(val, val_exp, n: int, **knobs) -> dict:
    """A checkpoint state: copies of the [n+1] heads (the callback may
    keep them; the run goes on updating its tensors in place)."""
    return {"val": val[:n + 1].clone(), "val_exp": val_exp[:n + 1].clone(),
            **knobs}


def _frontier_run(g, val, val_exp, kind: str, wparams, max_rounds: int,
                  delta: float | None = None, quantile_mass: int = 0,
                  on_round=None, checkpoint=None, start_rounds: int = 0,
                  bucket_end0: float | None = None, overlay=None):
    """Expansion-tracked round loop over the working arrays ``val`` /
    ``val_exp`` ([n+1+SPARE], updated in place): one plan readback a
    round, then one push per ~budget chunks of listed mass. ``delta``
    expands only the current distance bucket and advances it to the
    least pending value when it drains; ``quantile_mass`` takes a
    device-computed threshold; neither expands every improved vertex.

    ``checkpoint(rounds, state)`` is called at every round boundary
    (after the ``on_round`` veto) with ``{"val", "val_exp"}`` ([n+1]
    copies), ``bucket_end`` and ``quantile_mass``; a run restarted from
    it through ``start_rounds`` / ``bucket_end0`` / ``quantile_mass``
    continues the trajectory bit-equal. The graph dict's optional
    ``_trace_rounds`` list collects ``(band, nf, m8, t, plan_s)`` a
    round; with ``_trace_plan_drain`` set, the queued pushes are drained
    before each plan so ``plan_s`` times the plan alone."""
    n = g["n"]
    is_f32 = val.dtype == torch.float32
    ov = overlay if overlay is not None and not overlay.empty else None
    R = _Round(g, kind, wparams, is_f32, ov)
    if R.has_adds and start_rounds == 0 and bucket_end0 is None:
        # fresh start: the overlay's one-hop reach of the initial values
        R.relax(val)
    if quantile_mass and not is_f32:
        quantile_mass = 0                   # the threshold is float-only
    bucket_end = R.big if not delta or delta <= 0 else delta
    if bucket_end0 is not None:
        bucket_end = bucket_end0
    trace = g.get("_trace_rounds")
    drain = trace is not None and g.get("_trace_plan_drain")
    rounds = int(start_rounds)
    prev_sig = None
    while rounds < max_rounds:
        if on_round is not None and not on_round(rounds):
            raise RoundInterrupted(rounds)
        if checkpoint is not None:
            checkpoint(rounds, _state(val, val_exp, n, bucket_end=bucket_end,
                                      quantile_mass=quantile_mass))
        if drain:
            _sync(val)
        t_plan = time.time()
        qf_cap, stats, flist, bounds, thr = R.plan(val, val_exp, bucket_end,
                                                   quantile_mass)
        nf, m8, overflow, pmin = _stats_host(stats.tolist(), is_f32)
        plan_s = time.time() - t_plan
        if overflow:
            raise _refuse_overflow(kind)
        if trace is not None:
            trace.append((0.0 if quantile_mass else float(bucket_end),
                          nf, m8, time.time(), plan_s))
        if nf == 0 or m8 == 0:
            if R.has_adds:
                # the base plan is dry: only overlay edges can progress;
                # stop when a relax improves nothing
                if int(R.relax(val)) > 0:
                    rounds += 1
                    continue
            if float(pmin) >= R.big * (1 - 1e-6):
                return val[:n], rounds          # no pending work anywhere
            if quantile_mass:
                # fp corner: fall back to the expand-everything threshold
                quantile_mass = 0
                continue
            if delta and delta > 0:
                # bucket drained: advance to the least pending value's
                bucket_end = float((np.floor(float(pmin) / delta) + 1)
                                   * delta)
                continue
            raise RuntimeError(
                f"frontier_{kind}: empty round with pending work "
                f"(pmin={pmin!r}) in plain mode")
        # a round that changed nothing (every member deferred): full-size
        # kernels for one round
        sig = (nf, m8, float(pmin), float(bucket_end), quantile_mass)
        escalate = sig == prev_sig
        prev_sig = sig
        R.push(val, val_exp, nf, m8, escalate, qf_cap, flist, bounds, thr)
        rounds += 1
    return val[:n], rounds


# --------------------------------------------------------------------------
# cohorts
# --------------------------------------------------------------------------

class _CohortMember:
    """One cohort member's tensors and the mode knobs ``_frontier_run``
    keeps in locals, so each decision the cohort makes for it is the one
    its solo run makes."""

    __slots__ = ("k", "val", "val_exp", "bucket_end", "quantile_mass",
                 "prev_sig", "rounds", "out", "stopped")

    def __init__(self, k: int, val, val_exp, bucket_end, quantile_mass):
        self.k = k
        self.val = val
        self.val_exp = val_exp
        self.bucket_end = bucket_end
        self.quantile_mass = int(quantile_mass)
        self.prev_sig = None
        self.rounds = 0
        self.out = None        # [n] result once terminated
        self.stopped = None    # on_round veto: the vetoed round number


def _frontier_cohort(g, members, kind: str, wparams, max_rounds: int,
                     delta: float = 0.0, on_round=None, checkpoint=None,
                     overlay=None) -> None:
    """The round loop over K members: each round plans every active
    member, reads all K stats back with ONE ``.tolist()``, and runs each
    member's pushes with the sequential loop's decisions, so each
    member's arrays and round count equal its solo ``_frontier_run``.
    Re-plans that do not advance a round (the sequential ``continue``s)
    run solo for that member. ``on_round(k, rounds)`` and
    ``checkpoint(k, rounds, state)`` are per member; a vetoed member
    records ``stopped`` and leaves. Fresh starts only."""
    n = g["n"]
    is_f32 = members[0].val.dtype == torch.float32
    ov = overlay if overlay is not None and not overlay.empty else None
    R = _Round(g, kind, wparams, is_f32, ov)
    if R.has_adds:
        for m in members:
            R.relax(m.val)

    def _boundary(m) -> bool:
        """Veto, then checkpoint; False = the member was vetoed out."""
        if on_round is not None and not on_round(m.k, m.rounds):
            m.stopped = m.rounds
            return False
        if checkpoint is not None:
            checkpoint(m.k, m.rounds, _state(
                m.val, m.val_exp, n, bucket_end=m.bucket_end,
                quantile_mass=m.quantile_mass))
        return True

    def _host_step(m, st, plan) -> str:
        """'done' | 'advanced' | 'replan' over one member's stats."""
        qf_cap, _stats, flist, bounds, thr = plan
        nf, m8, overflow, pmin = _stats_host(st, is_f32)
        if overflow:
            raise _refuse_overflow(kind)
        if nf == 0 or m8 == 0:
            if R.has_adds and int(R.relax(m.val)) > 0:
                m.rounds += 1
                return "advanced"
            if float(pmin) >= R.big * (1 - 1e-6):
                m.out = m.val[:n]
                return "done"
            if m.quantile_mass:
                m.quantile_mass = 0
                return "replan"
            if delta and delta > 0:
                m.bucket_end = float(
                    (np.floor(float(pmin) / delta) + 1) * delta)
                return "replan"
            raise RuntimeError(
                f"frontier_{kind}: empty round with pending work "
                f"(pmin={pmin!r}) in plain mode")
        sig = (nf, m8, float(pmin), float(m.bucket_end), m.quantile_mass)
        escalate = sig == m.prev_sig
        m.prev_sig = sig
        R.push(m.val, m.val_exp, nf, m8, escalate, qf_cap, flist, bounds,
               thr)
        m.rounds += 1
        return "advanced"

    def _plan(m):
        return R.plan(m.val, m.val_exp, m.bucket_end, m.quantile_mass)

    def _solo(m) -> None:
        """Drain a member's re-plan rounds alone."""
        while m.out is None and m.stopped is None \
                and m.rounds < max_rounds:
            if not _boundary(m):
                return
            plan = _plan(m)
            if _host_step(m, plan[1].tolist(), plan) != "replan":
                return
        if m.out is None and m.stopped is None:
            m.out = m.val[:n]                # max_rounds exhausted

    active = list(members)
    while True:
        for m in active:
            if m.rounds >= max_rounds and m.out is None \
                    and m.stopped is None:
                m.out = m.val[:n]
        active = [m for m in active if m.out is None and m.stopped is None]
        if not active:
            return
        ready = [(m, _plan(m)) for m in active if _boundary(m)]
        if not ready:
            continue
        # the amortization: K members' plans in one readback
        st_all = torch.stack([p[1] for _m, p in ready]).tolist()
        replans = [m for (m, plan), st in zip(ready, st_all)
                   if _host_step(m, st, plan) == "replan"]
        for m in replans:
            _solo(m)


def _host_outs(members, return_device: bool):
    return [m.out if return_device or m.out is None
            else m.out.cpu().numpy() for m in members]


def _sssp_init(n: int, source: int, dev):
    val = torch.full((n + 1 + SPARE,), float(FINF), dtype=torch.float32,
                     device=dev)
    val[source] = 0.0
    # nothing has pushed yet: only the source reads as improved
    return val, torch.full_like(val, float(FINF))


def _quantile_default(delta, quantile_mass) -> tuple[float, int]:
    """The default mode: quantile bands unless delta buckets are asked
    for (the JAX package's rule)."""
    delta = 0.0 if delta is None else delta
    if quantile_mass is None:
        quantile_mass = 0 if delta and delta > 0 else QUANTILE_MASS_DEFAULT
    return delta, int(quantile_mass)


def frontier_sssp_batched(snap_or_graph, sources, min_w: float = 0.0,
                          w_range: float = 1.0, max_rounds: int = 10_000,
                          delta: float | None = None,
                          quantile_mass: int | None = None,
                          on_round=None, checkpoint=None,
                          return_device: bool = False, overlay=None,
                          device=None):
    """K-source SSSP cohort over one round loop: each member's distances
    and round count equal ``frontier_sssp(source=sources[k])`` with the
    same knobs. ``on_round(k, rounds)``: per-member veto (a False drops
    member k; ``stopped[k]`` records the round). ``checkpoint(k, rounds,
    state)``: the sequential state per member. Returns ``(dists, rounds,
    stopped)`` lists of length K; a vetoed member's dist is None."""
    dev = resolve_device(device)
    g = _graph(snap_or_graph, dev)
    n = g["n"]
    delta, quantile_mass = _quantile_default(delta, quantile_mass)
    overlay = _overlay_of(snap_or_graph, overlay)
    bucket0 = float(FINF) if not delta or delta <= 0 else float(delta)
    members = [_CohortMember(k, *_sssp_init(n, int(s), g["dstT"].device),
                             bucket0, quantile_mass)
               for k, s in enumerate(sources)]
    _frontier_cohort(g, members, "sssp", (min_w, w_range), max_rounds,
                     delta=float(delta), on_round=on_round,
                     checkpoint=checkpoint, overlay=overlay)
    return _host_outs(members, return_device), \
        [m.rounds for m in members], [m.stopped for m in members]


def _wcc_start(g, overlay):
    """(val, val_exp, levels) of a fresh WCC run. Without an overlay, one
    BFS from the max-degree vertex peels its component: it collapses to
    its least id, already expanded; the rest start at their own id,
    improved. With an overlay (the BFS has no overlay seam) every vertex
    starts at its own id, improved."""
    n = g["n"]
    dev = g["dstT"].device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    if overlay is not None:
        val, exp, levels = ids, ids + 1, 0
    else:
        seed_v = int(torch.argmax(g["deg"][:n]))
        # max_levels=n: a truncated BFS would freeze part of a component
        dist, levels = frontier_bfs_hybrid(g, seed_v, max_levels=n,
                                           return_device=True, device=dev)
        reached = dist[:n] < INF
        rmin = torch.where(reached, ids, int(IINF)).min()
        val = torch.where(reached, rmin, ids)
        exp = torch.where(reached, val, val + 1)
    tail = ids.new_full((1 + SPARE,), int(IINF))
    return torch.cat([val, tail]), torch.cat([exp, tail]), levels


def frontier_wcc_batched(snap_or_graph, count: int,
                         max_rounds: int = 10_000, on_round=None,
                         checkpoint=None, return_device: bool = False,
                         overlay=None, device=None):
    """K-member WCC cohort: the BFS peel and seed labels are computed once
    and copied per member; members differ only in their hooks. Each
    member's labels and round count equal a solo ``frontier_wcc``.
    Checkpoint states carry ``levels``. Returns ``(labels, rounds,
    stopped)`` with rounds including the peel's level count."""
    dev = resolve_device(device)
    g = _graph(snap_or_graph, dev)
    overlay = _overlay_of(snap_or_graph, overlay)
    n = g["n"]
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=g["dstT"].device)
        out = z if return_device else z.cpu().numpy()
        return [out] * count, [0] * count, [None] * count
    val0, exp0, levels = _wcc_start(g, overlay)
    ck = None
    if checkpoint is not None:
        def ck(k, rounds, state):
            checkpoint(k, rounds, {**state, "levels": levels})
    # every member owns its tensors: the pushes update them in place
    members = [_CohortMember(k, val0.clone(), exp0.clone(), int(IINF), 0)
               for k in range(count)]
    _frontier_cohort(g, members, "wcc", (0.0, 0.0), max_rounds,
                     on_round=on_round, checkpoint=ck, overlay=overlay)
    return _host_outs(members, return_device), \
        [m.rounds + levels for m in members], [m.stopped for m in members]


def frontier_sssp(snap_or_graph, source_dense: int, min_w: float = 0.0,
                  w_range: float = 1.0, max_rounds: int = 10_000,
                  delta: float | None = None,
                  quantile_mass: int | None = None,
                  return_device: bool = False, on_round=None,
                  checkpoint=None, resume: dict | None = None,
                  overlay=None, device=None):
    """SSSP over hashed edge weights with an expansion-tracked frontier.
    Returns ``(dist float32 [n] with FINF unreachable, rounds)``; dist is
    a device tensor when ``return_device``, else numpy.

    Modes: quantile bands (the default), ``delta`` > 0 delta-stepping
    buckets, ``quantile_mass=0`` the plain improved-set frontier.
    ``checkpoint(rounds, state)``: round-boundary capture (see
    ``_frontier_run``). ``resume``: ``{"val", "val_exp"}`` ([n+1]
    float32, tensors or arrays, a JAX package state included),
    ``rounds``, ``bucket_end`` and ``quantile_mass`` from a checkpoint;
    the final distances are bit-equal to an uninterrupted run."""
    dev = resolve_device(device)
    g = _graph(snap_or_graph, dev)
    n = g["n"]
    delta, quantile_mass = _quantile_default(delta, quantile_mass)
    start_rounds, bucket_end0 = 0, None
    if resume is not None:
        val = _with_spare(_as_state(resume["val"], torch.float32,
                                    g["dstT"].device), float(FINF))
        val_exp = _with_spare(_as_state(resume["val_exp"], torch.float32,
                                        g["dstT"].device), float(FINF))
        start_rounds = int(resume["rounds"])
        bucket_end0 = float(resume["bucket_end"])
        quantile_mass = int(resume["quantile_mass"])
    else:
        val, val_exp = _sssp_init(n, int(source_dense), g["dstT"].device)
    out, rounds = _frontier_run(
        g, val, val_exp, "sssp", (min_w, w_range), max_rounds, delta=delta,
        quantile_mass=quantile_mass, on_round=on_round,
        checkpoint=checkpoint, start_rounds=start_rounds,
        bucket_end0=bucket_end0,
        overlay=_overlay_of(snap_or_graph, overlay))
    return (out if return_device else out.cpu().numpy()), rounds


def _as_state(x, dtype, dev):
    """A resumed state (a tensor, or an array such as a JAX package state
    read back) as a tensor of its own on ``dev``."""
    if torch.is_tensor(x):
        return x.to(dev, dtype).clone()
    return torch.from_numpy(np.array(x)).to(dev, dtype)


def frontier_wcc(snap_or_graph, max_rounds: int = 10_000,
                 return_device: bool = False, on_round=None,
                 checkpoint=None, resume: dict | None = None,
                 overlay=None, device=None):
    """Connected components of a symmetric graph: the BFS peel, then
    min-label propagation over the remaining components. Returns ``(label
    int32 [n] = component's least vertex id, rounds)``, rounds counting
    the BFS levels too.

    ``checkpoint(rounds, state)``: propagation-phase capture (the state
    also carries ``levels``). ``resume``: ``{"val", "val_exp", "rounds",
    "levels"}``; skips the peel, and the labels are bit-equal to an
    uninterrupted run."""
    dev = resolve_device(device)
    g = _graph(snap_or_graph, dev)
    overlay = _overlay_of(snap_or_graph, overlay)
    n = g["n"]
    if n == 0:
        out = torch.zeros(0, dtype=torch.int32, device=g["dstT"].device)
        return (out if return_device else out.cpu().numpy()), 0
    start_rounds = 0
    if resume is not None:
        val = _with_spare(_as_state(resume["val"], torch.int32,
                                    g["dstT"].device), int(IINF))
        val_exp = _with_spare(_as_state(resume["val_exp"], torch.int32,
                                        g["dstT"].device), int(IINF))
        start_rounds = int(resume["rounds"])
        levels = int(resume.get("levels", 0))
    else:
        val, val_exp, levels = _wcc_start(g, overlay)
    ck = None
    if checkpoint is not None:
        def ck(rounds, state):
            checkpoint(rounds, {**state, "levels": levels})
    out, rounds = _frontier_run(g, val, val_exp, "wcc", (0.0, 0.0),
                                max_rounds, on_round=on_round, checkpoint=ck,
                                start_rounds=start_rounds, overlay=overlay)
    return (out if return_device else out.cpu().numpy()), rounds + levels


# --------------------------------------------------------------------------
# dense-window PageRank
# --------------------------------------------------------------------------

def _pr_windows(g):
    """(start, end) column windows of ``DENSE_WINDOW``. JAX clamps the last
    window's start so its static shape fits and masks the overlap to add
    0; an exact-size last window adds the same (x + 0.0 == x for the
    nonnegative sums here)."""
    total = g["q_total"]
    W = min(DENSE_WINDOW, total)
    return [(w0, min(w0 + W, total)) for w0 in range(0, total, W)]


def _pr_window_plan(g, w0: int, w1: int):
    """A window's column owners (int64) and per-lane scatter targets
    ([8, w] int64, pads into the spare slots), shared by every rank row."""
    n = g["n"]
    cols = torch.arange(w0, w1, device=g["dstT"].device)
    return (_colowner(g)[w0:w1].long(),
            _targets(g["dstT"][:, w0:w1], n, cols[None, :]))


def _pr_window_add(acc, contrib, plan) -> None:
    """acc[nbr] += contrib[owner] over one window, in place, lane by lane
    in JAX's row-major order."""
    owner, tgt = plan
    c = contrib[owner]
    for lane in range(tgt.shape[0]):
        acc.index_add_(0, tgt[lane], c)


def _pr_contrib(rank, deg):
    return torch.where(deg > 0, rank / torch.clamp(deg, min=1.0), 0.0)


def _pr_finish(acc, rank, deg, damping, n_: int):
    """Uniform finish: new = (1-d)/n + d * acc (one rounding of the fused
    multiply-add XLA emits), the L1 delta and the next contributions."""
    d = torch.tensor(damping, dtype=torch.float32)
    base = (1.0 - d) / n_
    new = (acc[:n_].to(torch.float64) * float(d) + float(base)) \
        .to(torch.float32)
    return _pr_close(new, rank, deg, n_)


def _pr_finish_reset(acc, rank, reset, deg, damping, n_: int):
    """Personalized finish: new = (1-d) * reset + d * acc, as XLA fuses
    it: d * acc rounded, then one rounding of (1-d) * reset plus that.
    ``models/pagerank.pagerank_personalized_batched`` runs this very
    function row by row."""
    d = torch.tensor(damping, dtype=torch.float32)
    new = (reset[:n_].to(torch.float64) * float(1.0 - d)
           + (acc[:n_] * float(d)).to(torch.float64)).to(torch.float32)
    return _pr_close(new, rank, deg, n_)


def _pr_close(new, rank, deg, n_: int):
    new_rank = torch.cat([new, new.new_zeros(1)])
    delta = (new - rank[:n_]).abs().sum()
    return new_rank, _pr_contrib(new_rank, deg), delta


def _pr_setup(snap_or_graph, overlay, device, what: str):
    ov = _overlay_of(snap_or_graph, overlay)
    if ov is not None:
        # dense sweeps read contiguous base-CSR column windows: there is
        # no per-edge seam for tombstones or adds
        raise RuntimeError(
            f"{what} on a live overlay: compact the overlay first "
            "(LiveGraphPlane.compact_if_dirty) — dense window sweeps have "
            "no overlay seam")
    dev = resolve_device(device)
    g = _graph(snap_or_graph, dev)
    return g, g["deg"].to(torch.float32)


def _acc(shape_head, g):
    n = g["n"]
    return torch.zeros((*shape_head, n + 1 + SPARE), dtype=torch.float32,
                       device=g["dstT"].device)


def pagerank_dense(snap_or_graph, iterations: int = 20,
                   damping: float = 0.85, tol: float | None = None,
                   return_device: bool = False, on_round=None,
                   checkpoint=None, resume: dict | None = None,
                   overlay=None, reset=None, device=None):
    """Push-mode PageRank over the chunked CSR by dense column windows:
    rank' = (1-d)/n + d * sum over in-edges of rank[src]/outdeg[src]
    (dangling mass leaks, as the engine's program does). Returns ``(rank
    float32 [n], iterations run)``. ``tol``: stop once the L1 change falls
    below it. ``on_round(it)``: per-iteration veto (RoundInterrupted).
    ``checkpoint(it, {"rank": rank})`` after each iteration (a copy of
    the [n+1] ranks); ``resume``: ``{"rank", "it"}``. ``reset`` ([n],
    summing to 1): personalized PageRank, teleporting to (and starting
    at) that distribution. Refuses a non-empty live overlay.

    On a card the window scatter-add (``index_add_``) adds in no fixed
    order, so ranks agree with another run or the JAX package within
    float32 summation error, not bit for bit; on the CPU the order is
    fixed."""
    g, deg = _pr_setup(snap_or_graph, overlay, device, "pagerank_dense")
    n = g["n"]
    dev = g["dstT"].device
    reset_dev = None
    if reset is not None:
        r = _as_state(reset, torch.float32, dev)
        if tuple(r.shape) != (n,):
            raise ValueError(f"reset must be [n={n}], got {tuple(r.shape)}")
        reset_dev = torch.cat([r, r.new_zeros(1)])
    it0 = 0
    if resume is not None:
        rank = _as_state(resume["rank"], torch.float32, dev)
        it0 = int(resume["it"])
    elif reset_dev is not None:
        rank = reset_dev
    else:
        rank = torch.full((n + 1,), 1.0 / n, dtype=torch.float32,
                          device=dev)
        rank[n] = 0.0
    contrib = _pr_contrib(rank, deg)
    windows = _pr_windows(g)
    it = it0
    for it in range(it0 + 1, iterations + 1):
        if on_round is not None and not on_round(it - 1):
            raise RoundInterrupted(it - 1)
        acc = _acc((), g)
        for w0, w1 in windows:
            _pr_window_add(acc, contrib, _pr_window_plan(g, w0, w1))
        if reset_dev is None:
            rank, contrib, delta = _pr_finish(acc, rank, deg, damping, n)
        else:
            rank, contrib, delta = _pr_finish_reset(acc, rank, reset_dev,
                                                    deg, damping, n)
        if checkpoint is not None:
            checkpoint(it, {"rank": rank.clone()})
        if tol is not None and float(delta) < tol:
            break
    out = rank[:n]
    return (out if return_device else out.cpu().numpy()), it
