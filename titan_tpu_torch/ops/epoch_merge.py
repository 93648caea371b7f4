"""Device-side epoch merge: overlay + base chunked CSR -> next-epoch CSR
(port of ``titan_tpu/ops/epoch_merge.py``).

Every input of the merge already lies on the device: the base ``dstT``
(``models/bfs_hybrid.build_chunked_csr``), the overlay's COO add-buffer
and its tombstone bitmap (``olap/live/overlay``). The next epoch's
chunked CSR is computed from them there, so an epoch's host-to-device
cost is the overlay delta the views already shipped, not the graph.

Within one source vertex ``u`` the merged segment is a two-way merge of
two dst-sorted runs: the surviving base slots (dst-ascending within
``u``) and ``u``'s overlay adds (sorted by (dst, append order)), base
rows winning dst ties. The host oracle (``EpochCompactor.merge`` +
``from_arrays`` + ``build_chunked_csr``) gets that from one global
stable sort; here it falls out of three passes with no sort over the
base:

1. **survivor compaction**: one ``alive`` mask (non-pad, not
   tombstoned) feeds ``ops/compaction.scatter_compact``, which lists the
   kept base values in (vertex, dst) order;
2. **add placement**: a live add's slot in the new layout is
   ``colstart'[u]*8 + rank among u's adds + #kept(u, dst <= d)``; the
   kept count is a 32-step vectorized binary search over ``u``'s old
   padded segment (dst-ascending with trailing ``n+1`` pads) composed
   with the alive prefix sum;
3. **complement fill**: the adds scatter into the new flat array, and
   the kept survivors fill the remaining valid slots of each segment in
   order: one free-slot prefix sum gives every slot its kept rank, one
   gather pulls the survivor's value.

Plain PyTorch on the base CSR's device, as the JAX version is eager XLA.
JAX semantics kept by hand: prefix sums stay int32 (``torch.cumsum``
would widen to int64, 1.1 GB a temporary at 139.6 M slots), both sorts
are stable, and the scatters JAX drops (``mode="drop"``) land in a spare
slot past the end that nothing reads. Slot ids must stay below 2^31:
callers check :func:`fits_int32` and take the host merge otherwise.

The contract (tests/test_torch_epoch_merge.py): :func:`merge_chunked_csr`
equals ``build_chunked_csr`` of the host oracle's merged snapshot,
array for array, and the JAX package's merge on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from titan_tpu_torch.obs import devprof
from titan_tpu_torch.ops.compaction import scatter_compact

#: binary-search depth: covers any segment below 2^31 slots (the int32
#: guard bounds every slot id under that anyway)
_BSEARCH_ITERS = 32


def fits_int32(q_total: int) -> bool:
    """True when a chunked CSR of ``q_total`` columns is addressable with
    int32 slot ids (slot = column*8 + lane)."""
    return q_total * 8 < (1 << 31)


class LazyHostMirror:
    """The ``_host`` mirror of a device-merged chunked CSR, built on
    first access instead of downloaded. ``colstart`` and ``degc`` come
    from the merge's host bookkeeping; the flat ``dstT`` is recomputed
    from the merged snapshot's out-CSR on the first ``["dstT"]`` only."""

    def __init__(self, snapshot, colstart: np.ndarray, degc: np.ndarray):
        self._snap = snapshot
        self._built = {"colstart": colstart, "degc": degc}

    def __getitem__(self, key: str):
        if key == "dstT" and "dstT" not in self._built:
            self._built["dstT"] = self._build_dstT()
        return self._built[key]

    def _build_dstT(self) -> np.ndarray:
        # the layout math of models/bfs_hybrid.build_chunked_csr
        snap = self._snap
        n = snap.n
        dst_by_src, indptr_out = snap.out_csr()
        deg = snap.out_degree.astype(np.int64)
        colstart = self._built["colstart"].astype(np.int64)
        q_total = int(colstart[-1]) + 1
        flat = np.full(q_total * 8, n + 1, np.int32)
        starts8 = colstart[:n] * 8
        pos = np.repeat(starts8 - indptr_out[:n], deg[:n]) \
            + np.arange(len(dst_by_src), dtype=np.int64)
        flat[pos] = dst_by_src
        return np.ascontiguousarray(flat.reshape(q_total, 8).T)


def merged_degrees_host(snapshot, overlay):
    """Host O(n + delta) bookkeeping for the merged layout: ``(deg, degc,
    colstart, q_total)`` of the NEXT epoch, as numpy (the output
    allocation needs ``q_total`` before the merge runs)."""
    n = int(snapshot.n)
    tombs_per_src = np.zeros(n, np.int64)
    if overlay.tomb_count:
        np.add.at(tombs_per_src,
                  snapshot.src[overlay.tomb_row_mask].astype(np.int64), 1)
    adds_per_src = np.zeros(n, np.int64)
    a_src, _, _ = overlay.live_adds()
    if len(a_src):
        np.add.at(adds_per_src, a_src.astype(np.int64), 1)
    deg = snapshot.out_degree.astype(np.int64) - tombs_per_src \
        + adds_per_src
    degc = -(-deg // 8)
    colstart = np.zeros(n + 1, np.int64)
    np.cumsum(degc, out=colstart[1:])
    q_total = int(colstart[-1]) + 1
    return (np.concatenate([deg, [0]]).astype(np.int32),
            np.concatenate([degc, [0]]).astype(np.int32),
            colstart.astype(np.int32), q_total)


def _bitmap_bits(tomb_dev, q_total: int):
    """The [q_total]-byte tombstone bitmap as a [q_total*8] bool vector in
    slot order (slot s -> byte s>>3, bit s&7)."""
    lanes = torch.arange(8, dtype=torch.uint8, device=tomb_dev.device)
    return ((tomb_dev[:, None] >> lanes) & 1).bool().reshape(q_total * 8)


def _upper_bound_segmented(flat, lo, hi, needle):
    """Vectorized per-query binary search: for each query i, the absolute
    upper-bound position of ``needle[i]`` within ``flat[lo[i]:hi[i]]``
    (each segment ascending). All int32; ``lo == hi`` (an empty segment)
    answers ``lo``."""
    last = max(flat.shape[0] - 1, 0)
    for _ in range(_BSEARCH_ITERS):
        mid = lo + (hi - lo) // 2          # no lo + hi int32 overflow
        v = flat[mid.clamp(0, last).long()]
        active = lo < hi
        take = active & (v <= needle)
        lo = torch.where(take, mid + 1, lo)
        hi = torch.where(active & ~take, mid, hi)
    return lo


def _cumsum0(x):
    """int32 prefix sum with a leading 0: ``out[k]`` = sum of ``x[:k]``."""
    out = torch.zeros(x.shape[0] + 1, dtype=torch.int32, device=x.device)
    torch.cumsum(x, 0, dtype=torch.int32, out=out[1:])
    return out


def merge_chunked_csr(csr: dict, view, *, q_total_new: int,
                      e_base: int) -> dict:
    """Merge ``csr`` (a ``build_chunked_csr`` dict on the device) with an
    ``OverlayView`` on the same device into the next epoch's chunked CSR.
    ``q_total_new`` is the host-computed output column count
    (:func:`merged_degrees_host`); ``e_base`` the base edge count.

    Returns ``dstT`` / ``colstart`` / ``degc`` / ``deg`` / ``q_total`` /
    ``n`` (the caller attaches the ``_host`` mirror). Raises
    ``ValueError`` on inputs the int32 layout cannot express; callers
    catch it and take the host path. Runs under ``obs/devprof`` as
    kernel ``ops.epoch_merge`` (CUDA events around the whole merge)."""
    return devprof.profiled("ops.epoch_merge", _merge_chunked_csr,
                            csr, view, q_total_new=q_total_new,
                            e_base=e_base)


def _merge_chunked_csr(csr: dict, view, *, q_total_new: int,
                       e_base: int) -> dict:
    n = int(csr["n"])
    q_old = int(csr["q_total"])
    if e_base <= 0:
        raise ValueError("device merge needs a non-empty base CSR")
    if not (fits_int32(q_old) and fits_int32(q_total_new)):
        raise ValueError("chunked CSR exceeds int32 slot ids")
    if int(view.tomb_dev.shape[0]) != q_old:
        raise ValueError("overlay tombstone bitmap does not match the "
                         "base CSR layout (stale epoch?)")
    dev = csr["dstT"].device
    s_old = q_old * 8
    s_new = q_total_new * 8
    pad = n + 1

    # ---- survivors of the base (pass 1)
    flat = csr["dstT"].T.reshape(s_old)           # slot order (a copy)
    alive = (flat <= n) & ~_bitmap_bits(view.tomb_dev, q_old)
    css = _cumsum0(alive)          # css[k] = #alive slots in [0, k)
    colstart8 = csr["colstart"] * 8               # [n+1] int32 (guarded)
    kept_before = css[colstart8.long()]           # [n+1]
    kept_per_u = kept_before[1:] - kept_before[:-1]   # [n]
    _, (kfv,) = scatter_compact(alive, (flat,), e_base, (pad,))
    del alive

    # ---- add placement (pass 2)
    a_src, a_dst = view.src_dev, view.dst_dev     # [cap], pad n+1
    alive_add = a_src <= n
    # the pad rows' index n+1 is the spare slot JAX drops
    adds_per_u = torch.zeros(n + 2, dtype=torch.int32, device=dev) \
        .index_add_(0, a_src.long(), alive_add.to(torch.int32))[:n]
    deg_new_n = kept_per_u + adds_per_u
    degc_new_n = (deg_new_n + 7) // 8
    colstart_new = _cumsum0(degc_new_n)
    colstart8_new = colstart_new * 8
    # stable (src, dst, append order) sort of the cap-sized buffer: the
    # dead and pad rows (n+1, n+1) sink to the tail and stay masked
    o1 = torch.argsort(a_dst, stable=True)
    order = o1[torch.argsort(a_src[o1], stable=True)]
    sa_src = a_src[order]
    sa_dst = a_dst[order]
    sa_alive = sa_src <= n
    u_clip = sa_src.clamp(0, n).long()
    acs = _cumsum0(adds_per_u)[u_clip]
    rank = torch.arange(a_src.shape[0], dtype=torch.int32,
                        device=dev) - acs
    lo = colstart8[u_clip]
    hi = lo + csr["degc"][u_clip] * 8
    ub = _upper_bound_segmented(flat, lo, hi, sa_dst)
    kept_le = css[ub.long()] - css[lo.long()]     # tombstones excluded
    t_add = torch.where(sa_alive, colstart8_new[u_clip] + kept_le + rank,
                        s_new).long()            # masked rows: the spare
    out = torch.full((s_new + 1,), pad, dtype=torch.int32, device=dev)
    out.index_put_((t_add,), sa_dst)
    occ = torch.zeros(s_new + 1, dtype=torch.bool, device=dev)
    occ[t_add] = True
    out, occ = out[:s_new], occ[:s_new]
    del flat, css

    # ---- complement fill (pass 3)
    cols = torch.arange(q_total_new, dtype=torch.int32, device=dev)
    owner_col = (torch.searchsorted(colstart_new, cols, right=True,
                                    out_int32=True) - 1).clamp(0, n)
    owner = owner_col.repeat_interleave(8).long()  # [s_new]
    del cols, owner_col
    deg_new = torch.cat([deg_new_n, deg_new_n.new_zeros(1)])
    pos = torch.arange(s_new, dtype=torch.int32, device=dev) \
        - colstart8_new[owner]
    free = (pos < deg_new[owner]) & ~occ
    del pos, occ
    cfs = _cumsum0(free)
    kept_rank = cfs[:-1] - cfs[colstart8_new.long()][owner]
    del cfs
    src_idx = (kept_before[owner] + kept_rank).clamp(0, e_base - 1)
    del owner, kept_rank
    out = torch.where(free, kfv[src_idx.long()], out)

    return {"dstT": out.reshape(q_total_new, 8).T.contiguous(),
            "colstart": colstart_new,
            "degc": torch.cat([degc_new_n, degc_new_n.new_zeros(1)]),
            "deg": deg_new,
            "q_total": q_total_new,
            "n": n}
