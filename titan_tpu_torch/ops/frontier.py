"""The fused bottom-up chunk round: the Hopper kernel, its plain version
and the dispatching wrapper (port of ``titan_tpu/ops/pallas_frontier.py``).

One round over C candidates and K jobs: fetch the leading ``lanes`` rows
of each candidate's ``dstT`` column, test them against the K frontier
bitmaps (masking tombstoned ``col*8 + lane`` slots when ``tbits`` is
given), refetch all 8 lanes only for candidates that some undecided job
still missed, emit ``found [K, C]``, and compact the surviving
``(pay0, pay1)`` pairs in stable candidate order with ``fill0``/``fill1``
past the count — ``ops.compaction.scatter_compact``'s contract. The lane
ladder never changes a result: a narrow miss is re-tested at full width.

``frontier_round`` runs ``frontier_round_reference`` when its tensors lie
on the CPU, and the CUDA kernel (``csrc/frontier_round.cu``) when they
lie on a card; there is no other route. The kernel is built with
``nvcc`` at first use and bound with ctypes. It is one launch, a
persistent pass that ranks survivors by decoupled look-back between
tiles, after the wrapper zeroes its scratch (the tile statuses and a
ticket counter).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from titan_tpu_torch.build import build_cuda
from titan_tpu_torch.ops.compaction import scatter_compact


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (once per source hash) and bind the kernel library."""
    lib = ctypes.CDLL(build_cuda("frontier_round"))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tt_frontier_round.restype = i32
    lib.tt_frontier_round.argtypes = (
        [p] * 8                      # cols undec has_more pay0 pay1 fbits tbits dstT
        + [i64, i32, i64, i64, i64, i32, i32, i32]  # C K Q nb tb lanes fill0 fill1
        + [p] * 5                    # found out0 out1 nsur scratch
        + [p])                       # stream
    lib.tt_frontier_round_tile.restype = i32
    return lib


def _hit_any(fbits, tbits, par, pcols):
    """(l, C) gathered parents -> (K, C) any-lane bitmap hit, with
    tombstoned slots masked. Byte and slot indices are clamped into
    range exactly as the kernel clamps them. Goes job by job, so the
    temporaries stay (l, C) uint8 whatever K is (a whole [K, l, C] word
    array would take 34 GB at K = 16 and C = 2^26)."""
    nb = fbits.shape[1]
    byte = (par >> 3).clamp(0, nb - 1).long()
    shift = (par & 7).to(torch.uint8)
    open_ = None
    if tbits is not None:
        lane = torch.arange(par.shape[0], device=par.device)[:, None]
        slot = pcols[None, :] * 8 + lane                  # int64
        tw = tbits[(slot >> 3).clamp(0, tbits.shape[0] - 1)]
        open_ = ((tw >> (slot & 7).to(torch.uint8)) & 1) == 0
    out = torch.empty((fbits.shape[0], par.shape[1]), dtype=torch.bool,
                      device=par.device)
    for k in range(fbits.shape[0]):
        h = ((fbits[k][byte] >> shift) & 1) > 0           # (l, C)
        if open_ is not None:
            h &= open_
        torch.any(h, dim=0, out=out[k])
    return out


def frontier_round_reference(cols, undec, has_more, pay0, pay1, fbits,
                             tbits, dstT, *, lanes: int, fill0: int,
                             fill1: int):
    """Plain PyTorch version of the round, on any device. Returns
    ``(found [K, C] bool, pay0c [C], pay1c [C], nsur 0-d int32)``."""
    q_pad = dstT.shape[1] - 1
    c = cols.long().clamp(0, q_pad)
    undec = undec.bool()
    hit = _hit_any(fbits, tbits, dstT[:lanes][:, c], c)
    if lanes < 8:
        need_w = (undec & ~hit).any(dim=0)
        wc = torch.where(need_w, c, q_pad)
        hit = hit | (_hit_any(fbits, tbits, dstT[:, wc], wc) & need_w[None])
    found = undec & hit
    surv = (undec & ~hit).any(dim=0) & has_more.bool()
    nsur, (p0, p1) = scatter_compact(surv, (pay0, pay1), cols.shape[0],
                                     (fill0, fill1))
    return found, p0, p1, nsur


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"frontier_round: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"frontier_round: {name} lies on {t.device}, "
                         f"dstT on {device}")
    if not t.is_contiguous():
        raise ValueError(f"frontier_round: {name} must be contiguous")


def _launch(cols, undec, has_more, pay0, pay1, fbits, tbits, dstT, lanes,
            fill0, fill1):
    dev = dstT.device
    if dev.type != "cuda":
        raise ValueError(f"frontier_round: tensors on {dev}; the kernel "
                         "takes CUDA tensors and the plain path CPU ones")
    K, C = undec.shape
    Q = dstT.shape[1]
    if lanes not in (2, 8):
        raise ValueError(f"frontier_round: lanes={lanes}, expected 2 or 8")
    if C >= 2**31 or K < 1:
        raise ValueError(f"frontier_round: C={C}, K={K} out of range")
    _check("dstT", dstT, torch.int32, (8, Q), dev)
    _check("cols", cols, torch.int32, (C,), dev)
    _check("undec", undec, torch.bool, (K, C), dev)
    _check("has_more", has_more, torch.bool, (C,), dev)
    _check("pay0", pay0, torch.int32, (C,), dev)
    _check("pay1", pay1, torch.int32, (C,), dev)
    _check("fbits", fbits, torch.uint8, (K, fbits.shape[1]), dev)
    if tbits is not None:
        _check("tbits", tbits, torch.uint8, (tbits.shape[0],), dev)
    lib = kernel_library()
    found = torch.empty((K, C), dtype=torch.bool, device=dev)
    out0 = torch.empty((C,), dtype=torch.int32, device=dev)
    out1 = torch.empty((C,), dtype=torch.int32, device=dev)
    nsur = torch.empty((1,), dtype=torch.int32, device=dev)
    # the tile statuses, then the ticket counter; zeroed every call, so
    # no call reads a status an earlier one left
    scratch = torch.zeros((-(-C // lib.tt_frontier_round_tile()) + 1,),
                          dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tt_frontier_round(
        cols.data_ptr(), undec.data_ptr(), has_more.data_ptr(),
        pay0.data_ptr(), pay1.data_ptr(), fbits.data_ptr(),
        None if tbits is None else tbits.data_ptr(), dstT.data_ptr(),
        C, K, Q, fbits.shape[1], 0 if tbits is None else tbits.shape[0],
        lanes, fill0, fill1,
        found.data_ptr(), out0.data_ptr(), out1.data_ptr(), nsur.data_ptr(),
        scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"frontier_round: CUDA error {err} at launch")
    frontier_round.launches += 1
    return found, out0, out1, nsur[0]


def frontier_round(cols, undec, has_more, pay0, pay1, fbits, tbits, dstT,
                   *, lanes: int, fill0: int, fill1: int):
    """One fused chunk round (see the module doc).

    ``cols`` [C] int32 chunk columns (clamped into ``[0, q_pad]``);
    ``undec`` [K, C] bool — job k still wants candidate j decided;
    ``has_more`` [C] bool — candidate has chunks past this one;
    ``pay0``/``pay1`` [C] int32 payloads compacted for survivors;
    ``fbits`` [K, nbytes] uint8 little-endian frontier bitmaps;
    ``tbits`` [tbytes] uint8 slot bitmap or None; ``dstT`` [8, Q] int32.

    Returns ``(found [K, C] bool, pay0c [C], pay1c [C], nsur 0-d int32)``;
    on a card ``nsur`` stays on the device and nothing synchronises."""
    if dstT.device.type == "cpu":
        return frontier_round_reference(
            cols, undec, has_more, pay0, pay1, fbits, tbits, dstT,
            lanes=lanes, fill0=fill0, fill1=fill1)
    return _launch(cols, undec, has_more, pay0, pay1, fbits, tbits, dstT,
                   lanes, fill0, fill1)


#: kernel launches so far (the CPU path never counts)
frontier_round.launches = 0


def ladder_fetch_counts(cols, fbits, dstT, lanes: int, tbits=None):
    """The ladder's fetched-byte cost model, host-side numpy:
    ``(narrow_bytes, wide_bytes, baseline_bytes)`` for one round over
    chunk columns ``cols`` with one frontier bitmap ``fbits``. 4 bytes
    per fetched lane entry; every candidate pays ``lanes`` entries, only
    narrow misses pay the 8-lane refetch; the baseline is a flat 8-lane
    fetch. The port's copy of the JAX package's numpy function."""
    cols = np.asarray(cols)
    fb = np.asarray(fbits)
    dstT = np.asarray(dstT)

    def hit_any(par):
        h = (fb[par >> 3] >> (par & 7)) & 1
        if tbits is not None:
            lane = np.arange(par.shape[0], dtype=np.int64)[:, None]
            slot = cols[None, :] * 8 + lane
            h = h & ~((np.asarray(tbits)[slot >> 3] >> (slot & 7)) & 1)
        return h.any(axis=0)

    narrow_b = int(cols.size) * 4 * lanes
    missed = ~hit_any(dstT[:lanes][:, cols])
    wide_b = int(missed.sum()) * 4 * 8
    return narrow_b, wide_b, int(cols.size) * 4 * 8
