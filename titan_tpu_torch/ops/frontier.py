"""The fused bottom-up chunk round and the batched straggler sweep: the
Hopper kernels, their plain versions and the dispatching wrappers (port
of ``titan_tpu/ops/pallas_frontier.py``, and of the found-per-candidate
half of ``titan_tpu/models/bfs_hybrid.py``'s ``_batched_exhaust``).

**Frontier words.** K jobs' frontiers are vertex-major words: ``Kp =
min(next_pow2(K), 32)`` bits a vertex in each of ``G = ceil(K / 32)``
planes, ``fbits`` uint8 ``[G, nb]``. Job ``g*32 + k`` of vertex ``v`` is
bit ``v*Kp + k`` of plane ``g``, little-endian, so one load of a
parent's word tests every job of a group: ``Kp/8`` aligned bytes for
``Kp >= 8`` (2 bytes a vertex at K = 16), a ``Kp``-bit field of one byte
below that. K = 1 is the single-source BFS's bitmap, bit ``v`` at byte
``v >> 3``. A parent index is clamped into the plane as the kernels
clamp it (``words_at``): for ``Kp >= 8`` the word index into
``[0, nb*8/Kp - 1]``, below it the byte ``(par*Kp) >> 3`` into
``[0, nb - 1]`` with the bit offset ``(par*Kp) & 7``.

**The round** (``frontier_round``), over C candidates and K jobs: fetch
the leading ``lanes`` rows of each candidate's ``dstT`` column, test them
against the K frontiers (masking tombstoned ``col*8 + lane`` slots when
``tbits`` is given), refetch all 8 lanes only for candidates that some
undecided job still missed, emit ``found [K, C]``, and compact the
surviving ``(pay0, pay1)`` pairs in stable candidate order with
``fill0``/``fill1`` past the count — ``ops.compaction.scatter_compact``'s
contract. The lane ladder never changes a result: a narrow miss is
re-tested at full width.

**The sweep** (``batched_exhaust``): for each (candidate, chunk) pair
``j < p_total`` of ``enumerate_chunk_pairs``, the jobs whose frontier
holds an open parent of chunk ``cols[j]``, ORed into candidate
``owner[j]``: ``found_per [K, c_cap]`` bool.

Each wrapper runs its plain version when its tensors lie on the CPU, and
its CUDA kernel (``csrc/frontier_round.cu``, ``csrc/batched_exhaust.cu``)
when they lie on a card; there is no other route. A launch runs under
``torch.cuda.device`` of its tensors' card, so the launcher's grid (sized
for ``cudaGetDevice``) and its stream are that card's whichever device is
current, as when one process drives several cards. The kernels are built
with ``nvcc`` at first use and bound with ctypes. The round is one
launch, a persistent pass that ranks survivors by decoupled look-back
between tiles, after the wrapper zeroes its scratch (the tile statuses
and a ticket counter); the sweep is two: the frontier summary
(``_launch_summary``, plain version ``exhaust_summary_reference``: one
bit for each block of ``2^sh`` bytes of the planes, set where some plane
holds a nonzero byte there), then one
persistent pass into a zeroed ``[G, c_cap]`` word array that loads a
parent's word only where the summary's bit is set. Both wrappers are
``obs/devprof`` seams (``frontier_round``, ``batched_exhaust``, which
covers the summary's launch).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from titan_tpu_torch.build import build_cuda
from titan_tpu_torch.device import next_pow2, on_card
from titan_tpu_torch.obs import devprof
from titan_tpu_torch.ops.compaction import scatter_compact

#: exhaust pairs a slice of the plain sweep: its [8, slice] gathers and
#: [K, slice] job bits stay a few hundred MB at K = 16 however many
#: chunks the stragglers have left
EXHAUST_SLICE = 1 << 22
#: the sweep's frontier summary has at most this many bits (32 KB, held
#: in each block's shared memory; ``csrc/batched_exhaust.cu``'s cap)
SUMMARY_BITS = 1 << 18


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (once per source hash) and bind the round's library."""
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


@functools.cache
def exhaust_library() -> ctypes.CDLL:
    """Build (once per source hash) and bind the sweep's library."""
    lib = ctypes.CDLL(build_cuda("batched_exhaust"))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tt_batched_exhaust.restype = i32
    lib.tt_batched_exhaust.argtypes = (
        [p] * 7                      # cols owner p_total fbits tbits dstT summ
        + [i64, i32, i64, i64, i64, i64]  # P K Q nb tb c_cap
        + [i32, i64, p, p])          # sh nsw out stream
    lib.tt_exhaust_summary.restype = i32
    lib.tt_exhaust_summary.argtypes = [p, i32, i64, i32, i64, p, p]
    return lib


def word_bits(K: int) -> tuple[int, int]:
    """``(Kp, G)``: bits a vertex in a plane, and planes, for K jobs."""
    return min(next_pow2(K) if K > 1 else 1, 32), -(-K // 32)


def plane_bytes(nv: int, K: int) -> int:
    """Bytes of one plane of words over ``nv`` vertices."""
    return -(-nv * word_bits(K)[0] // 8)


def words_at(plane, par, Kp: int):
    """int32 words of one plane (uint8 [nb]) at int32 parent indices of
    any shape, clamped into the plane as the kernels clamp them."""
    nb = plane.shape[0]
    if Kp >= 8:
        view = plane.view({8: torch.uint8, 16: torch.int16,
                           32: torch.int32}[Kp])
        w = view[par.long().clamp(0, view.shape[0] - 1)].to(torch.int32)
        return w & 0xFFFF if Kp == 16 else w
    bit = par.long() * Kp
    b = plane[(bit >> 3).clamp(0, nb - 1)].to(torch.int32)
    return (b >> (bit & 7).to(torch.int32)) & ((1 << Kp) - 1)


def job_bits(words, K: int):
    """[G, ...] int32 words -> [K, ...] bool, job k from bit k % 32 of
    plane k // 32; job by job, so the temporaries stay one plane's size."""
    out = torch.empty((K, *words.shape[1:]), dtype=torch.bool,
                      device=words.device)
    for k in range(K):
        torch.ne((words[k >> 5] >> (k & 31)) & 1, 0, out=out[k])
    return out


def slot_open(tbits, cols):
    """[8, P] bool: slot ``col*8 + lane`` is not set in the slot bitmap
    ``tbits`` (byte = column, bit = lane; the byte clamped into range)."""
    byte = cols.long().clamp(0, tbits.shape[0] - 1)
    lane = torch.arange(8, dtype=torch.uint8, device=cols.device)[:, None]
    return ((tbits[byte][None, :] >> lane) & 1) == 0


def _hit_words(fbits, tbits, par, pcols, Kp: int):
    """(l, C) gathered parents -> [G, C] int32: the OR of the open
    parents' words, plane by plane, so the temporaries stay (l, C)
    whatever K is (a [K, l, C] array would take 34 GB at K = 16 and
    C = 2^26)."""
    open_ = None if tbits is None else slot_open(tbits, pcols)[:par.shape[0]]
    out = torch.zeros((fbits.shape[0], par.shape[1]), dtype=torch.int32,
                      device=par.device)
    for g in range(fbits.shape[0]):
        w = words_at(fbits[g], par, Kp)                  # (l, C)
        if open_ is not None:
            w.masked_fill_(~open_, 0)
        for row in w:
            out[g] |= row
    return out


def frontier_round_reference(cols, undec, has_more, pay0, pay1, fbits,
                             tbits, dstT, *, lanes: int, fill0: int,
                             fill1: int):
    """Plain PyTorch version of the round, on any device. Returns
    ``(found [K, C] bool, pay0c [C], pay1c [C], nsur 0-d int32)``."""
    q_pad = dstT.shape[1] - 1
    K = undec.shape[0]
    Kp, _ = word_bits(K)
    c = cols.long().clamp(0, q_pad)
    undec = undec.bool()
    hit = job_bits(_hit_words(fbits, tbits, dstT[:lanes][:, c], c, Kp), K)
    if lanes < 8:
        need_w = (undec & ~hit).any(dim=0)
        wc = torch.where(need_w, c, q_pad)
        hit |= job_bits(_hit_words(fbits, tbits, dstT[:, wc], wc, Kp), K) \
            & need_w[None]
    found = undec & hit
    surv = (undec & ~hit).any(dim=0) & has_more.bool()
    nsur, (p0, p1) = scatter_compact(surv, (pay0, pay1), cols.shape[0],
                                     (fill0, fill1))
    return found, p0, p1, nsur


def _check(who, name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{who}: {name} lies on {t.device}, "
                         f"dstT on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _check_words(who, fbits, tbits, dstT, K: int):
    """The checks the two kernels share: ``dstT`` [8, Q] int32, the words
    ``[G, nb]`` with whole words in a plane, ``tbits``; returns Q."""
    dev = dstT.device
    if dev.type != "cuda":
        raise ValueError(f"{who}: tensors on {dev}; the kernel takes CUDA "
                         "tensors and the plain path CPU ones")
    if K < 1:
        raise ValueError(f"{who}: K={K} out of range")
    Q = dstT.shape[1]
    Kp, G = word_bits(K)
    _check(who, "dstT", dstT, torch.int32, (8, Q), dev)
    _check(who, "fbits", fbits, torch.uint8, (G, fbits.shape[1]), dev)
    if fbits.shape[1] < 1 or fbits.shape[1] % max(Kp // 8, 1):
        raise ValueError(f"{who}: a plane of {fbits.shape[1]} bytes holds "
                         f"no whole number of {Kp}-bit words")
    if tbits is not None:
        _check(who, "tbits", tbits, torch.uint8, (tbits.shape[0],), dev)
    return Q


def _launch(cols, undec, has_more, pay0, pay1, fbits, tbits, dstT, lanes,
            fill0, fill1):
    who = "frontier_round"
    K, C = undec.shape
    Q = _check_words(who, fbits, tbits, dstT, K)
    dev = dstT.device
    if lanes not in (2, 8):
        raise ValueError(f"{who}: lanes={lanes}, expected 2 or 8")
    if C >= 2**31:
        raise ValueError(f"{who}: C={C} out of range")
    _check(who, "cols", cols, torch.int32, (C,), dev)
    _check(who, "undec", undec, torch.bool, (K, C), dev)
    _check(who, "has_more", has_more, torch.bool, (C,), dev)
    _check(who, "pay0", pay0, torch.int32, (C,), dev)
    _check(who, "pay1", pay1, torch.int32, (C,), dev)
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
        raise RuntimeError(f"{who}: CUDA error {err} at launch")
    frontier_round.launches += 1
    return found, out0, out1, nsur[0]


def frontier_round(cols, undec, has_more, pay0, pay1, fbits, tbits, dstT,
                   *, lanes: int, fill0: int, fill1: int):
    """One fused chunk round (see the module doc).

    ``cols`` [C] int32 chunk columns (clamped into ``[0, q_pad]``);
    ``undec`` [K, C] bool — job k still wants candidate j decided;
    ``has_more`` [C] bool — candidate has chunks past this one;
    ``pay0``/``pay1`` [C] int32 payloads compacted for survivors;
    ``fbits`` [G, nb] uint8 frontier words of the K jobs (module doc);
    ``tbits`` [tbytes] uint8 slot bitmap or None; ``dstT`` [8, Q] int32.

    Returns ``(found [K, C] bool, pay0c [C], pay1c [C], nsur 0-d int32)``;
    on a card ``nsur`` stays on the device and nothing synchronises."""
    if dstT.device.type == "cpu":
        return devprof.profiled(
            "frontier_round", frontier_round_reference, cols, undec,
            has_more, pay0, pay1, fbits, tbits, dstT, lanes=lanes,
            fill0=fill0, fill1=fill1)
    with on_card(dstT.device):
        return devprof.profiled("frontier_round", _launch, cols, undec,
                                has_more, pay0, pay1, fbits, tbits, dstT,
                                lanes, fill0, fill1)


#: kernel launches so far (the CPU path never counts)
frontier_round.launches = 0


def batched_exhaust_reference(cols, owner, p_total, fbits, tbits, dstT, *,
                              K: int, c_cap: int):
    """Plain PyTorch version of the sweep, in the JAX package's form: the
    pairs go in slices of ``EXHAUST_SLICE``; each slice's job bits fold
    into the per-candidate result with an ``amax`` by owner, dead pairs
    (``j >= p_total``, whose column is the pad column and whose parents
    are pads) into the last candidate with their 0, owners outside
    ``[0, c_cap)`` into a dropped spare. The fold is order-free, so the
    result does not depend on the slicing. Returns ``[K, c_cap]`` bool."""
    Kp, _ = word_bits(K)
    P = cols.shape[0]
    acc = torch.zeros((K, c_cap + 1), dtype=torch.int32, device=cols.device)
    for s0 in range(0, P, EXHAUST_SLICE):
        s1 = min(s0 + EXHAUST_SLICE, P)
        c = cols[s0:s1].long().clamp(0, dstT.shape[1] - 1)
        hit = job_bits(_hit_words(fbits, tbits, dstT[:, c], c, Kp), K)
        j = torch.arange(s0, s1, device=cols.device)
        own = owner[s0:s1].long()
        own = torch.where((own >= 0) & (own < c_cap), own, c_cap)
        own = torch.where(j < p_total, own, c_cap - 1)
        acc.scatter_reduce_(1, own[None, :].expand(K, -1),
                            hit.to(torch.int32), reduce="amax")
        del hit
    return acc[:, :c_cap] > 0


def summary_shape(nb: int, K: int) -> tuple[int, int]:
    """``(sh, nsw)`` of the sweep's frontier summary over planes of
    ``nb`` bytes: ``2^sh`` bytes a bit, the least power of two at or
    above a word's bytes that covers a plane in ``SUMMARY_BITS`` bits,
    and the summary's int32 words."""
    sh = (max(word_bits(K)[0] // 8, 1)).bit_length() - 1
    while (nb + (1 << sh) - 1) >> sh > SUMMARY_BITS:
        sh += 1
    return sh, -(-((nb + (1 << sh) - 1) >> sh) // 32)


def exhaust_summary_reference(fbits, K: int):
    """Plain PyTorch version of the summary: int32 ``[nsw]``, bit ``s``
    (bit ``s % 32`` of word ``s // 32``) set when some byte of
    ``[s << sh, (s + 1) << sh)`` of some plane of ``fbits`` is nonzero
    (``summary_shape``)."""
    nb = fbits.shape[1]
    sh, nsw = summary_shape(nb, K)
    nz = torch.zeros(nsw * 32 << sh, dtype=torch.bool, device=fbits.device)
    nz[:nb] = (fbits != 0).any(dim=0)
    bits = nz.view(nsw, 32, 1 << sh).any(dim=2).to(torch.int64)
    weight = torch.ones(32, dtype=torch.int64, device=fbits.device) \
        << torch.arange(32, device=fbits.device)
    weight[31] = -(1 << 31)          # bit 31 is the int32 sign bit
    return (bits * weight).sum(dim=1).to(torch.int32)


def _launch_summary(fbits, K: int):
    """One launch of ``csrc/batched_exhaust.cu``'s summary kernel over the
    K jobs' words (``fbits`` [G, nb] uint8, on a card): int32 ``[nsw]``,
    the bits ``exhaust_summary_reference`` sets. The sweep's wrapper
    launches it just before the sweep; the CPU sweep needs none."""
    who = "exhaust_summary"
    dev = fbits.device
    if dev.type != "cuda" or K < 1:
        raise ValueError(f"{who}: K={K} on {dev}; the kernel takes CUDA "
                         "tensors and K >= 1")
    Kp, G = word_bits(K)
    _check(who, "fbits", fbits, torch.uint8, (G, fbits.shape[1]), dev)
    if fbits.shape[1] < 1 or fbits.shape[1] % max(Kp // 8, 1):
        raise ValueError(f"{who}: a plane of {fbits.shape[1]} bytes holds "
                         f"no whole number of {Kp}-bit words")
    sh, nsw = summary_shape(fbits.shape[1], K)
    out = torch.empty(nsw, dtype=torch.int32, device=dev)
    with on_card(dev):
        err = exhaust_library().tt_exhaust_summary(
            fbits.data_ptr(), K, fbits.shape[1], sh, nsw, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{who}: CUDA error {err} at launch")
    _launch_summary.launches += 1
    return out


#: summary launches so far
_launch_summary.launches = 0


def _launch_exhaust(cols, owner, p_total, fbits, tbits, dstT, K, c_cap):
    """The kernel's ``[G, c_cap]`` int32 job words (the wrapper expands
    them), after the summary's launch."""
    who = "batched_exhaust"
    Q = _check_words(who, fbits, tbits, dstT, K)
    dev = dstT.device
    P = cols.shape[0]
    if not 1 <= c_cap < 2**31:
        raise ValueError(f"{who}: c_cap={c_cap} out of range")
    _check(who, "cols", cols, torch.int32, (P,), dev)
    _check(who, "owner", owner, torch.int32, (P,), dev)
    _check(who, "p_total", p_total, torch.int32, (), dev)
    lib = exhaust_library()
    out = torch.zeros((fbits.shape[0], c_cap), dtype=torch.int32,
                      device=dev)
    if P == 0:                      # at P = 0 nothing is launched
        return out
    sh, nsw = summary_shape(fbits.shape[1], K)
    summ = _launch_summary(fbits, K)
    err = lib.tt_batched_exhaust(
        cols.data_ptr(), owner.data_ptr(), p_total.data_ptr(),
        fbits.data_ptr(), None if tbits is None else tbits.data_ptr(),
        dstT.data_ptr(), summ.data_ptr(), P, K, Q, fbits.shape[1],
        0 if tbits is None else tbits.shape[0], c_cap, sh, nsw,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{who}: CUDA error {err} at launch")
    batched_exhaust.launches += 1
    return out


def batched_exhaust(cols, owner, p_total, fbits, tbits, dstT, *, K: int,
                    c_cap: int):
    """The batched BFS's straggler sweep (see the module doc).

    ``cols``/``owner`` [P] int32 from ``enumerate_chunk_pairs`` (chunk
    columns, clamped into ``[0, q_pad]``, and each pair's candidate);
    ``p_total`` 0-d int32, the live pairs (on a card it is read there:
    nothing synchronises); ``fbits`` [G, nb] uint8 frontier words of the
    K jobs; ``tbits`` slot bitmap or None; ``dstT`` [8, Q] int32.
    Returns ``found_per [K, c_cap]`` bool: some open parent of some live
    pair of the candidate is in job k's frontier."""
    if dstT.device.type == "cpu":
        return devprof.profiled("batched_exhaust", batched_exhaust_reference,
                                cols, owner, p_total, fbits, tbits, dstT,
                                K=K, c_cap=c_cap)
    with on_card(dstT.device):
        words = devprof.profiled("batched_exhaust", _launch_exhaust, cols,
                                 owner, p_total, fbits, tbits, dstT, K,
                                 c_cap)
    return job_bits(words, K)


#: kernel launches so far (the CPU path never counts)
batched_exhaust.launches = 0


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
