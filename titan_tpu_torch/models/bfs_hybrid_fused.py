"""The whole direction-optimizing BFS in one launch (port of
``titan_tpu/models/bfs_hybrid_fused.py``).

The JAX package keeps the level loop of ``frontier_bfs_hybrid`` on the
device: a ``lax.while_loop`` whose body picks, from four counts it keeps
there, the endgame, a top-down level or a bottom-up level, and
``lax.switch``es into a ladder of prebuilt bucket widths, so a whole BFS
costs one dispatch and one readback. Eager PyTorch cannot hold such a
loop on the card, so the port's counterpart is a kernel written by hand:
``csrc/bfs_fused.cu``, one cooperative launch that runs every level and
meets at grid-wide barriers. Its plain version, ``fused_bfs_reference``,
is a Python level loop in torch that takes the same decisions from the
same counts, read back each level. CPU tensors take the plain version;
CUDA tensors launch the kernel or raise.

What is kept from the JAX package:

* the counts a level decides by (``_level_stats``): the frontier's size
  and chunk mass, the unvisited chunk mass and the unvisited vertices
  with a chunk;
* the rule: the endgame when ``n_unvis <= end_c`` and ``m8_unvis <=
  end_p``; bottom-up when ``m8_f > m8_unvis // 8`` and ``f > 1``, or when
  the frontier passes the top pair of the top-down ladder (``td_top``);
  top-down otherwise. ``end_c = min(END_C_CAP, next_pow2(n))`` and
  ``end_p = min(END_P_CAP, next_pow2(total_chunks + 1))``;
* the level count's arithmetic, which is not always
  ``frontier_bfs_hybrid``'s: a top-down or bottom-up level adds one; the
  endgame adds one a level it runs, the last of which finds nothing,
  then one more for the empty probe, capped at ``max_levels``
  (``bfs_hybrid_fused.py:366-370``). So an endgame that ends by finding
  nothing counts one level more than the hybrid's (ROADMAP queue 3,
  item 15);
* ``max_levels`` truncation.

What is dropped: the ladders' widths as loop sizes, and with them
``FUSED_BU_MAX`` and the overflow flag. XLA needs static shapes, so the
JAX program's bottom-up candidate list has a top width, past which it
flags an overflow and its entry point re-runs the BFS through the host-driven
hybrid. The kernel sizes its loops from counts on the card and truncates
nothing, and the plain version walks every candidate, so that case
cannot arise here and there is nothing to fall back to.

``dist`` has ``n + 2`` slots, as in the port's hybrid; only ``[0, n)``
is written. SYMMETRIC GRAPHS ONLY, as ``frontier_bfs_hybrid``.

Tracing: when the graph dict holds a list under ``"_trace_modes"``, the
plain version appends ``(level, mode, chunks)`` for each decision
(``mode`` one of ``MODES``, ``chunks`` the chunk columns whose dstT
column it gathered), and the kernel's wrapper appends ``(level, mode,
None)`` from the modes the kernel recorded. When it holds a list under
``"_trace_split"``, the kernel's wrapper hands the kernel a stamp buffer
and appends the launch's split (``level_split``: each level's mode and
the ms of its passes, from ``%globaltimer`` after each grid barrier);
the plain version appends nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from titan_tpu_torch.build import build_cuda
from titan_tpu_torch.device import INF, next_pow2, on_card, resolve_device
from titan_tpu_torch.models.bfs_hybrid import (_bit_of, _level_stats,
                                               _pack_bits, build_chunked_csr)
from titan_tpu_torch.obs import devprof

END_C_CAP = 1 << 21
END_P_CAP = 1 << 22
#: the top (f_cap, p_cap) pair of the JAX program's top-down ladder: a
#: frontier past it is taken bottom-up
FUSED_TD_MAX = (1 << 23, 1 << 25)
#: chunk rounds of a plain bottom-up level before the rest of each
#: survivor's chunks are swept at once
BU_CHUNK_ROUNDS = 8
#: the plain version's gathers go in slices of about this many chunk
#: columns, so its temporaries stay a few hundred MB at scale 26
SLICE = 1 << 22
#: the decisions, by the kernel's code
MODES = ("endgame", "td", "bu")
#: the kernel records this many decisions; a longer BFS records the first
MODE_CAP = 1024


def td_top(n: int, total_chunks: int) -> tuple[int, int]:
    """The top pair of the JAX program's top-down ladder (``_ladders``):
    ``FUSED_TD_MAX`` capped by ``next_pow2(n)`` and
    ``next_pow2(total_chunks + 1)``."""
    cap_n = next_pow2(max(n, 2))
    cap_q = next_pow2(max(total_chunks + 1, 2))
    return min(FUSED_TD_MAX[0], cap_n), min(FUSED_TD_MAX[1], cap_q)


def end_caps(n: int, total_chunks: int) -> tuple[int, int]:
    """``(end_c, end_p)``: the endgame's entry caps for this graph."""
    return (min(END_C_CAP, next_pow2(max(n, 2))),
            min(END_P_CAP, next_pow2(max(total_chunks + 1, 2))))


def choose_mode(st, end_c: int, end_p: int, top) -> int:
    """The index in ``MODES`` of the level's decision from its counts
    ``[f, m8_f, m8_unvis, n_unvis]``."""
    f, m8f, m8u, nu = st
    if nu <= end_c and m8u <= end_p:
        return 0
    if (m8f > m8u // 8 and f > 1) or m8f > top[1] or f > top[0]:
        return 2
    return 1


def _slices(counts):
    """Bounds ``(lo, hi)`` of consecutive items whose ``counts`` (int64,
    on any device) sum to about ``SLICE`` each; an item is never split."""
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1]) if counts.numel() else 0
    if total == 0:
        return []
    begins = ends - counts
    marks = torch.arange(0, total, SLICE, device=counts.device)
    cuts = torch.searchsorted(begins, marks).tolist() + [counts.numel()]
    return [(lo, hi) for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]


def _pairs(starts, counts):
    """Every (item, chunk) pair of a slice: ``(cols, owner)``, int64,
    item i's chunks ``starts[i] .. starts[i] + counts[i] - 1``."""
    owner = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    cols = starts[owner] + torch.arange(owner.numel(),
                                        device=counts.device) - first[owner]
    return cols, owner


def _td_level(dist, level: int, g) -> int:
    """Every neighbour of the frontier (dist == level) at INF takes
    level + 1. Returns the chunk columns gathered."""
    n_ = g["n"]
    dstT, colstart, degc = g["dstT"], g["colstart"], g["degc"]
    fr = torch.nonzero(dist[:n_] == level).flatten()
    counts = degc[fr].long()
    chunks = 0
    for lo, hi in _slices(counts):
        cols, _ = _pairs(colstart[fr[lo:hi]].long(), counts[lo:hi])
        nbr = dstT[:, cols].reshape(-1).long()      # pad n + 1: spare slot
        dist.scatter_reduce_(0, nbr, torch.full_like(nbr, level + 1,
                                                     dtype=dist.dtype),
                             reduce="amin")
        chunks += cols.numel()
    return chunks


def _bu_found(fbits, cand, g):
    """Which candidates (int64 vertices, each with a chunk) have a parent
    whose bit is set in ``fbits``: ``BU_CHUNK_ROUNDS`` rounds of one
    chunk each over the still undecided, then every remaining chunk of
    the rest at once. Returns ``(found bool [len(cand)], chunks)``."""
    dstT, colstart, degc = g["dstT"], g["colstart"], g["degc"]
    dev = cand.device
    found = torch.zeros(cand.numel(), dtype=torch.bool, device=dev)
    todo = torch.arange(cand.numel(), device=dev)
    chunks = 0
    for r in range(BU_CHUNK_ROUNDS):
        todo = todo[degc[cand[todo]] > r]
        if todo.numel() == 0:
            return found, chunks
        hit = torch.empty(todo.numel(), dtype=torch.bool, device=dev)
        for lo in range(0, todo.numel(), SLICE):
            cols = colstart[cand[todo[lo:lo + SLICE]]].long() + r
            hit[lo:lo + SLICE] = _bit_of(fbits, dstT[:, cols]).any(dim=0)
        chunks += todo.numel()
        found[todo[hit]] = True
        todo = todo[~hit]
    todo = todo[degc[cand[todo]] > BU_CHUNK_ROUNDS]
    rem = (degc[cand[todo]] - BU_CHUNK_ROUNDS).long()
    for lo, hi in _slices(rem):
        part = todo[lo:hi]
        cols, owner = _pairs(
            colstart[cand[part]].long() + BU_CHUNK_ROUNDS, rem[lo:hi])
        hit = _bit_of(fbits, dstT[:, cols]).any(dim=0)
        per = torch.zeros(hi - lo, dtype=torch.int32, device=dev) \
            .scatter_reduce_(0, owner, hit.to(torch.int32), reduce="amax")
        found[part[per > 0]] = True
        chunks += cols.numel()
    return found, chunks


def _unvisited(dist, g):
    n_ = g["n"]
    return torch.nonzero((dist[:n_] >= INF) & (g["degc"][:n_] > 0)) \
        .flatten()


def fused_bfs_reference(g, source: int, max_levels: int = 1000):
    """Plain PyTorch version of the kernel, on any device: the JAX
    program's decisions and level count, one level at a time, the counts
    read back each level. Returns ``(dist [n+2] int32, levels)``."""
    n_ = g["n"]
    dstT, degc = g["dstT"], g["degc"]
    trace = g.get("_trace_modes")
    end_c, end_p = end_caps(n_, g["q_total"] - 1)
    top = td_top(n_, g["q_total"] - 1)
    dist = torch.full((n_ + 2,), INF, dtype=torch.int32, device=dstT.device)
    dist[source] = 0
    st = _level_stats(dist, degc, -1, n_).tolist()
    level = 0
    while st[0] != 0 and level < max_levels:
        mode = choose_mode(st, end_c, end_p, top)
        if mode == 0:
            cand = _unvisited(dist, g)
            lvl, nfound, chunks = level, 1, 0
            while nfound > 0 and lvl < max_levels:
                found, c = _bu_found(_pack_bits(dist, lvl, n_), cand, g)
                dist[cand[found]] = lvl + 1
                cand = cand[~found]
                nfound = int(found.sum())
                chunks += c
                lvl += 1
            if trace is not None:
                trace.append((level, MODES[0], chunks))
            level = min(lvl + 1, max_levels)   # +1: the empty probe level
            break
        if mode == 2:
            cand = _unvisited(dist, g)
            found, chunks = _bu_found(_pack_bits(dist, level, n_), cand, g)
            dist[cand[found]] = level + 1
        else:
            chunks = _td_level(dist, level, g)
        if trace is not None:
            trace.append((level, MODES[mode], chunks))
        st = _level_stats(dist, degc, level, n_).tolist()
        level += 1
    return dist, level


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (once per source hash) and bind the kernel's library."""
    lib = ctypes.CDLL(build_cuda("bfs_fused"))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tt_bfs_fused.restype = i32
    lib.tt_bfs_fused.argtypes = (
        [p] * 10                     # dist dstT colstart degc bits work giant ctr info stamps
        + [i64] * 8                  # n Q nwords source end_c end_p top_f top_p
        + [i32, i32, i64, p])        # max_lv mode_cap stamp_cap stream
    lib.tt_bfs_fused_counters.restype = i32
    lib.tt_bfs_fused_giant.restype = i32
    lib.tt_bfs_fused_grid.restype = i32
    return lib


def _launch(g, source: int, max_levels: int):
    who = "fused_bfs"
    n_ = g["n"]
    dstT, colstart, degc = g["dstT"], g["colstart"], g["degc"]
    dev = dstT.device
    if dev.type != "cuda":
        raise ValueError(f"{who}: tensors on {dev}; the kernel takes CUDA "
                         "tensors and the plain path CPU ones")
    Q = dstT.shape[1]
    for name, t, shape in (("dstT", dstT, (8, Q)),
                           ("colstart", colstart, (n_ + 1,)),
                           ("degc", degc, (n_ + 1,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous int32 "
                             f"{shape} on {dev}")
    if not 0 <= source < n_:
        raise ValueError(f"{who}: source {source} out of range")
    lib = kernel_library()
    end_c, end_p = end_caps(n_, g["q_total"] - 1)
    top = td_top(n_, g["q_total"] - 1)
    dist = torch.full((n_ + 2,), INF, dtype=torch.int32, device=dev)
    dist[source] = 0
    nwords = -(-(n_ + 2) // 32)
    # the visited, no-chunk and three frontier bitmaps (42 MB at scale 26)
    bits = torch.zeros((5, nwords), dtype=torch.int32, device=dev)
    # the warp list from the front, the block list from the back; the
    # grid list (each of its vertices has more than giant chunks)
    work = torch.empty(n_, dtype=torch.int32, device=dev)
    giant = torch.empty(Q // lib.tt_bfs_fused_giant() + 1,
                        dtype=torch.int32, device=dev)
    ctr = torch.zeros(lib.tt_bfs_fused_counters(), dtype=torch.int64,
                      device=dev)
    info = torch.zeros(2 + MODE_CAP, dtype=torch.int32, device=dev)
    split = g.get("_trace_split")
    stamps = (None if split is None else
              torch.zeros(3 + 3 * MODE_CAP, dtype=torch.int64, device=dev))
    max_lv = max(min(int(max_levels), 2**31 - 2), 0)
    err = lib.tt_bfs_fused(
        dist.data_ptr(), dstT.data_ptr(), colstart.data_ptr(),
        degc.data_ptr(), bits.data_ptr(), work.data_ptr(), giant.data_ptr(),
        ctr.data_ptr(), info.data_ptr(),
        None if stamps is None else stamps.data_ptr(), n_, Q, nwords,
        source, end_c, end_p, top[0], top[1], max_lv, MODE_CAP,
        0 if stamps is None else stamps.numel(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{who}: CUDA error {err} at launch (a "
                           "cooperative launch needs every block resident)")
    fused_bfs.launches += 1
    out = info.tolist()                  # the one readback
    levels, nrec = out[0], out[1]
    trace = g.get("_trace_modes")
    if trace is not None:
        trace.extend((None, MODES[m], None) for m in out[2:2 + nrec])
    if split is not None:
        split.append(level_split(stamps.tolist(), out[2:2 + nrec]))
    return dist, levels


def level_split(stamps, modes) -> dict:
    """The kernel's ``%globaltimer`` stamps (ns) as ms: its first pass
    (``init_ms``), then a level at a time its mode (the recorded
    decisions; the endgame's later levels record none) and the time of
    its phases: ``top_ms`` from the last barrier to the level's top (the
    decision and the clearing of a frontier bitmap), ``scan_ms`` and
    ``walk_ms`` (``walk_lists``)."""
    ran = min(int(stamps[0]), (len(stamps) - 3) // 3)
    rows, prev = [], stamps[2]
    for e in range(ran):
        t = stamps[3 + 3 * e:6 + 3 * e]
        rows.append({"mode": MODES[modes[e]] if e < len(modes) else MODES[0],
                     "top_ms": (t[0] - prev) / 1e6,
                     "scan_ms": (t[1] - t[0]) / 1e6,
                     "walk_ms": (t[2] - t[1]) / 1e6})
        prev = t[2]
    return {"init_ms": (stamps[2] - stamps[1]) / 1e6, "levels": rows,
            "total_ms": (prev - stamps[1]) / 1e6}


def fused_bfs(g, source: int, max_levels: int = 1000):
    """The whole BFS on the chunked-CSR dict ``g`` (see the module doc):
    the plain version for CPU tensors, one cooperative launch of
    ``csrc/bfs_fused.cu`` for CUDA tensors. Returns ``(dist [n+2] int32,
    levels)``; on a card ``dist`` stays there and the only readback is
    the kernel's small record of levels and modes."""
    if g["dstT"].device.type == "cpu":
        return devprof.profiled("bfs_fused", fused_bfs_reference, g,
                                source, max_levels)
    with on_card(g["dstT"].device):
        return devprof.profiled("bfs_fused", _launch, g, source, max_levels)


#: kernel launches so far (the CPU path never counts)
fused_bfs.launches = 0


def frontier_bfs_hybrid_fused(snap, source_dense: int,
                              max_levels: int = 1000,
                              return_device: bool = False, device=None):
    """Single-launch direction-optimizing BFS from ``source_dense``.
    ``snap`` is a snapshot (duck-typed, see ``build_chunked_csr``) or a
    chunked-CSR dict on ``device``. Returns ``(dist, levels)``: ``dist``
    int32 over [n] (INF = unreachable), a device tensor when
    ``return_device`` else numpy, equal to ``frontier_bfs_hybrid``'s;
    ``levels`` the JAX program's count (module doc)."""
    dev = resolve_device(device)
    g = snap if isinstance(snap, dict) else build_chunked_csr(snap, dev)
    if g["dstT"].device.type != dev.type:
        raise ValueError(f"graph lies on {g['dstT'].device}, device={dev}")
    dist, levels = fused_bfs(g, int(source_dense), max_levels)
    out = dist[:g["n"]]
    return (out if return_device else out.cpu().numpy()), levels
