#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # both main paths at their full sizes

Phases, each of which raises on failure:

1. print the card's name and power limit; build the kernels from the
   sources in the checkout (``nvcc`` for ``csrc/frontier_round.cu``,
   ``csrc/batched_exhaust.cu`` and ``csrc/seg_scan.cu``, ``g++`` for the
   native Graph500 library), all at once, and print each kernel's ptxas
   registers, shared memory and spills; start the host builds of the two
   Graph500 graphs (scale 22, then scale 26) in the background;
2. hold the ``frontier_round`` CUDA kernel bit-equal to its plain PyTorch
   version on the card, the K jobs' frontiers as vertex-major words:
   K in {1, 3, 16, 17}, lanes in {2, 8},
   tbits absent and given, C in {70, 2^20}, a case with Q > 2^28
   (64-bit offsets), one
   with C = 3*2^22 + 4099 (far more tiles than are resident at once),
   K = 5 with out-of-range columns, parents and slots (the clamps),
   K = 40 (two groups of jobs), every candidate missing the narrow
   lanes, no survivors, every candidate a survivor, C = 1, C one past a
   multiple of the tile, and the opener's shape on a real graph (scale
   ``CASE_SCALE``: the unvisited vertices in order, so the columns rise
   and lie close together, then dead slots); then ``REPEATS``
   back-to-back launches of the largest case, each bit-equal to the
   first; then the ``batched_exhaust`` kernel bit-equal to its plain
   version: K in {1, 3, 16, 40} with p_total < P, tbits, one owner over
   2^17 warps (a hub), each pair its own owner, p_total 0 and 1,
   out-of-range columns and parents (the clamps); then ``REPEATS``
   back-to-back launches of the hub and the K = 40 case, each bit-equal
   to the first;
3. hold the ``seg_scan`` CUDA kernel against its plain PyTorch version on
   the card, for every combine (sum, min, max) and type (float32,
   int32): E in {1, 70, a tile - 1, a tile, a tile + 1, 2^20,
   3*2^22 + 4099} with random segment starts, one segment spanning every
   tile (a pure carry chain, far more tiles than are resident at once),
   hub-like segments spanning 2-300 tiles among short ones, every element
   its own segment, and ``flags[0]`` False. Exact except float32 sums
   (``FLOAT_SUM_RTOL``). Then ``REPEATS`` back-to-back float32 sums of
   the one-segment and the hub inputs, each run bit-equal to the first
   (stale statuses and look-back races would show here). Then the K-row
   launch: K in ``ROW_KS``, E below a tile, odd, 2 mod 4 and 2 mod 4
   with hub-like starts, the row stride ld = E and padded to 4, every
   type and combine; every row bit-equal to the one-row launch on that
   row and the whole to the plain version; ``REPEATS`` back-to-back
   K = 16 launches bit-equal to the first;
4. at Graph500 scale 16, the port's BFS on the card equals the port's
   BFS on the CPU (plain path), and ``frontier_round`` was launched;
5. the vertex-program engine's main path at Graph500 scale 22, edge
   factor 16 (the JAX package's LiveJournal-class PageRank graph):
   ``from_chunked_csr``, upload, then PageRank (alpha 0.85, 20
   iterations), BFS and WCC through ``GPUGraphComputer.run``, all
   through ``seg_scan``. PageRank is held to a float64 scipy PageRank
   (``PAGERANK_RTOL``), BFS to ``frontier_bfs_hybrid`` exactly and WCC
   to scipy's components (each label the smallest id of its component).
   Then one PageRank superstep's message array is replayed: the kernel
   against its plain version, its byte bound and
   ``torch.segment_reduce``, beside an int32 ``min`` at the same flags
   and a plain ``copy_`` of the messages; and the superstep's parts are
   timed. Phase 5b, on the same snapshot: ``GPUGraphComputer.run_batched``
   of K = 16 BFS sources (bench.py's rule), each row's dist and
   iterations equal to ``GPUGraphComputer.run`` and dist to
   ``frontier_bfs_hybrid``, and of K = 4 PageRank jobs, each row
   bit-equal to the single run; walls, peak memory, launches, and each
   batch's widest K-row scan replayed (``row_scan_replay``: rows against
   the one-row launch and the plain version, the two byte bounds, and
   ``torch.segment_reduce`` over the rows for float32). Phase 5c:
   PageRank checkpointed every ``CKPT_EVERY`` supersteps, bit-equal to
   the run without checkpoints; rounds 15 and 20 removed and resumed,
   round 10 corrupted and resumed from 5 (``latest`` falls back), both
   bit-equal; a classic MapReduce (an in-degree histogram over the
   vertex views) against numpy;
6. the BFS main path at the full scale: native R-MAT host build, upload,
   direction-optimizing BFS from sources sampled by bench.py's rule (one
   warm-up run, best of 3 per source), TEPS as bench.py computes it, and
   Graph500's validation rules checked on the card. One run a source is
   traced (CUDA events around every ``frontier_round`` call, the summed
   kernel time printed a source); then two of the traced calls are replayed to
   time the kernel against its plain version and its bound: the widest
   (the first of the largest C) and the one whose bound bytes are
   largest (``round_bytes``: the smaller of the ``[8, Q]`` and ``[Q, 8]``
   counts of the dstT sectors);
7. the batched ``[K, n]`` BFS on phase 6's graph: the serving layer's
   BFS cohort (K = 16 sources by bench.py's rule; one warm-up, best of
   3, one traced run) with every row bit-equal to ``frontier_bfs_hybrid``
   from its source, its wall time beside the 16 single-source best
   times, the per-level split into plan, rounds and exhaust, each
   ``batched_exhaust`` call's time, the largest exhaust ``p_cap`` and
   the peak memory; the interactive lane's hops batch (K = 16, depth 2,
   ``start_level`` 1, the depth kept by an ``on_level`` mask) against a
   top-down expansion in plain torch; the widest K = 16
   ``frontier_round`` call replayed twice, as run and with 1% of slots
   tombstoned, then cut to its first 4, 8 and 16 jobs (``k_sweep``); the
   largest cohort sweep replayed (``batched_exhaust`` against its plain
   version, its time against ``exhaust_bytes``' bound); then at scale 16
   the batched BFS on the card
   equals the CPU port under a live overlay with adds and removals, with
   level masks, in a checkpoint and a resume from it, and with jobs
   dropped through ``on_level``;
8. the frontier models at scale 22, on a chunked-CSR dict from phase 5's
   host build: ``pagerank_dense`` as bench.py's LiveJournal stage runs it
   (2 warm-up iterations, then seconds an iteration over 10) and its
   20-iteration ranks against phase 5's float64 PageRank; the batched
   personalized PageRank of 16 users (bench.py's source rule), every row
   against ``pagerank_dense(reset=one-hot)`` on the card
   (``PPR_RTOL``), and its ``top_k_per_user``; ``frontier_sssp`` from
   bench.py's SSSP source (the first vertex of degree > 0), checked by
   its edges (``check_sssp``); ``frontier_wcc`` equal to scipy's
   components; the K = 4 SSSP cohort, every row and round count
   bit-equal to its solo run;
9. bench.py's ``sssp_wcc`` stage on phase 6's scale-26 graph: one
   ``frontier_sssp`` with ``_trace_rounds`` and ``_trace_plan_drain``
   set (seconds, rounds, plan seconds a round, each round's plan and
   pushes), then ``frontier_wcc`` without them (seconds, rounds, the
   ``frontier_round`` launches of its BFS peel), the peak memory; SSSP
   checked by its edges, WCC by its edges and label rules, its giant
   label's set equal to the set a BFS from phase 6's first source
   reaches;
10. the serving layer at s22 (run after phase 8, on phase 5's snapshot,
   under a device profiler for the whole phase): the chunked CSR built
   once, its ``torch.cuda.memory_allocated`` growth against
   ``snapshot_csr_bytes`` (``ALLOC_SLACK``) and the second call cached;
   then ``JobScheduler`` (``olap/serving``) on the card, paused while
   each stream is submitted: 16 BFS jobs from phase 5b's sources fused
   into one K = 16 batch (occupancy, every row equal to
   ``frontier_bfs_hybrid``), its wall from the first submit against a
   direct ``frontier_bfs_batched`` call, one K = 1 job's latency, the
   ledger's resident bytes; a mixed stream under two tenants (an SSSP
   and a WCC cohort of 4, 2 ``pagerank`` and 2 ``dense`` PageRank jobs),
   SSSP and WCC equal to the direct calls, ``pagerank`` to
   ``pagerank_dense`` within ``FLOAT_SUM_RTOL``, ``dense`` bit-equal to
   phase 5's ``GPUGraphComputer.run``, the tenants' device-seconds equal
   to the batches' walls; a BFS crashed at level 2 and a dense PageRank
   at superstep 10 (``FaultPlan``), both resumed from checkpoints on
   attempt 2 and bit-equal to their uninterrupted runs; a cancel and an
   expired deadline; ``bfs.chunked_csr`` counted once; the
   ``device.exec`` children of the three kernels; the K = 16 batch with
   the profiler on and off, in turns. The served runs' launches are
   ``launches_by_path["serving"]`` of each kernel.

The line before the last is the ``{"kernels": [...]}`` record of the
three kernels (each record's ``launches`` sums its paths, listed under
``launches_by_path``; ``seg_scan``'s ``rows`` holds phase 5b's two
K-row replays); the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SCALE = 26                       # the BFS main path: bench.py's "bfs26"
EDGE_FACTOR = 16
SEED = 2
SMALL_SCALE = 16
CASE_SCALE = 20                  # phase 2's opener-shaped rounds
ENGINE_SCALE = 22                # the engine's: bench.py's lj_scale
NUM_SOURCES = 4
REPS = 3
HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
KERNEL = {"name": "frontier_round", "route": "cuda",
          "source": "titan_tpu_torch/csrc/frontier_round.cu",
          "replaces": "titan_tpu/ops/pallas_frontier.py:79"}
SEG_KERNEL = {"name": "seg_scan", "route": "cuda",
              "source": "titan_tpu_torch/csrc/seg_scan.cu",
              "replaces": "titan_tpu/ops/pallas_segment.py:41"}
#: the batched BFS's straggler sweep: its JAX counterpart is XLA (the
#: found-per-candidate half of _batched_exhaust), not a Pallas kernel
EXHAUST_KERNEL = {"name": "batched_exhaust", "route": "cuda",
                  "source": "titan_tpu_torch/csrc/batched_exhaust.cu",
                  "replaces": "titan_tpu/models/bfs_hybrid.py:1070"}
#: float32 sums: |kernel - plain| <= FLOAT_SUM_RTOL * (the scan of |x|).
#: The kernel adds in tile order (16 in a thread, a warp tree, a block
#: tree: about 27 adds inside a tile, then the carry, a left fold with one
#: add a tile the segment spans) and the plain version in Hillis-Steele
#: order (log2 E <= 27 adds); each order's error is at most its depth
#: times float32's 2^-24 times the scan of |x|. That bound holds on the
#: engine's graph, where a hub spans at most 40 tiles: under 100 adds in
#: all, 6e-6 of the scan of |x|. It does not hold for phase 3's longest
#: segments: the one-segment case folds 3073 tiles (bound 1.9e-4) and the
#: hub case up to 300 (2.1e-5). Those cases stay inside 1e-5 only because
#: their values, uniform in [-1, 1) at a fixed seed, cancel: each add errs
#: by at most 2^-24 of the running sum, and running sums of values of
#: random sign stay far below the scan of |x|. Positive values (as
#: PageRank's messages) over such spans would not.
FLOAT_SUM_RTOL = 1e-5
#: back-to-back launches of phase 3's repeat check
REPEATS = 20
#: PageRank at s22 against float64: max |r32 - r64| / r64. Each float32
#: superstep's sums err by at most about 80 * 2^-24 (5e-6) relative (the
#: messages are positive); PageRank contracts by alpha = 0.85 a step, so
#: 20 steps accumulate under 5e-6 / 0.15 = 3.3e-5.
PAGERANK_RTOL = 1e-4
#: a personalized row against pagerank_dense(reset=one-hot) on the card,
#: max |a - b| / b over b > 0 (and a == 0 exactly where b == 0): both
#: add the same positive float32 terms, each in the order its atomics
#: land, so each is within PAGERANK_RTOL of the exact ranks by the
#: argument above and the two within twice that
PPR_RTOL = 2 * PAGERANK_RTOL
#: the personalized batch: the interactive lane's max_batch
PPR_USERS = 16
#: the SSSP cohort of phase 8
SSSP_COHORT = 4


T0 = time.time()


def say(msg: str) -> None:
    """Print a progress line with the seconds since the script started."""
    print(f"[{time.time() - T0:6.1f}s] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


class Background(threading.Thread):
    """Runs fn() in a daemon thread; ``result()`` joins and re-raises."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self.fn, self.out, self.err = fn, None, None
        self.start()

    def run(self):
        try:
            self.out = self.fn()
        except BaseException as e:  # re-raised in the caller's thread
            self.err = e

    def result(self):
        self.join()
        if self.err is not None:
            raise self.err
        return self.out


def ptxas_lines(lib) -> list[str]:
    """The register, shared-memory and spill lines of a kernel library's
    ``-Xptxas -v`` log (``titan_tpu_torch.build``), each once, with the
    number of the library's kernels that print it."""
    with open(lib._name + ".log") as f:
        lines = [re.sub(r"^ptxas info\s*:\s*", "", ln.strip()) for ln in f
                 if re.search(r"registers|spill", ln)]
    return [f"{lines.count(ln)}x {ln}" for ln in dict.fromkeys(lines)]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def pack_rows(bits):
    """[K, 8*nb] bool -> [K, nb] uint8 little-endian bitmaps (uint8
    temporaries: the bits of a byte are distinct, so the sum is an OR)."""
    sh = torch.arange(8, dtype=torch.uint8, device=bits.device)
    K = bits.shape[0]
    return (bits.view(K, -1, 8).to(torch.uint8) << sh).sum(
        -1, dtype=torch.uint8)


def word_bits(K: int) -> tuple[int, int]:
    """(Kp, G) of the vertex-major frontier words of K jobs: Kp =
    min(next_pow2(K), 32) bits a vertex in each of G = ceil(K / 32)
    planes; job g*32 + k of vertex v is bit v*Kp + k of plane g
    (``titan_tpu_torch/ops/frontier.py``)."""
    return min(1 << (K - 1).bit_length(), 32), -(-K // 32)


def rows_to_words(rows, K: int):
    """[K, nb] uint8 job-major bitmaps -> [G, nb*Kp] uint8 words, in
    plain torch and independent of the package's packer."""
    Kp, G = word_bits(K)
    nb, dev = rows.shape[1], rows.device
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    out = torch.empty((G, nb * Kp), dtype=torch.uint8, device=dev)
    for g in range(G):
        w = torch.zeros(nb * 8, dtype=torch.int64, device=dev)
        for k in range(min(32, K - 32 * g)):
            bit = ((rows[32 * g + k][:, None] >> shifts) & 1).flatten()
            w |= bit.long() << k
        if Kp >= 8:
            out[g] = w.view(torch.uint8).view(nb * 8, 8)[:, :Kp // 8] \
                .flatten()
        else:
            sh = torch.arange(8 // Kp, device=dev) * Kp
            out[g] = (w.view(-1, 8 // Kp) << sh).sum(1).to(torch.uint8)
    return out


def words_to_rows(words, K: int):
    """[G, plane] uint8 words -> [K, ceil(nv/8)] uint8 job-major bitmaps,
    nv = plane*8/Kp vertices; the inverse of ``rows_to_words``."""
    Kp, G = word_bits(K)
    plane, dev = words.shape[1], words.device
    nv = plane * 8 // Kp
    if Kp >= 8:
        b = words.view(G, nv, Kp // 8).long()
        w = sum(b[:, :, i] << (8 * i) for i in range(Kp // 8))
    else:
        sh = torch.arange(8 // Kp, device=dev) * Kp
        w = ((words[:, :, None].long() >> sh) & ((1 << Kp) - 1)) \
            .view(G, -1)[:, :nv]
    bits = torch.zeros((K, -(-nv // 8) * 8), dtype=torch.bool, device=dev)
    for k in range(K):
        bits[k, :nv] = ((w[k // 32] >> (k % 32)) & 1) > 0
    return pack_rows(bits)


def as_rows(fbits, K: int):
    """``(rows, plane)``: the job-major [K, nb] bitmaps of a round's
    ``fbits`` and the bytes of a words plane of them. ``fbits`` is words
    ([G, plane]); a [K, nb] array at K > 1 (G < K there) is the
    job-major layout of the port before words, taken as it is so a copy
    of this file can count a parent checkout's calls."""
    Kp, _ = word_bits(K)
    if K > 1 and fbits.shape[0] == K:
        return fbits, fbits.shape[1] * Kp
    return (fbits if K == 1 else words_to_rows(fbits, K)), fbits.shape[1]


def first_jobs(a, k: int) -> dict:
    """The round ``a`` cut to its first k jobs (``undec`` rows and the
    frontier bits), in the layout ``a`` came in."""
    K = a["undec"].shape[0]
    rows, _ = as_rows(a["fbits"], K)
    rows = rows[:k].contiguous()
    job_major = K > 1 and a["fbits"].shape[0] == K
    return {**a, "undec": a["undec"][:k].contiguous(),
            "fbits": rows if job_major or k == 1 else rows_to_words(rows, k)}


def round_inputs(gen, K, C, Q, n_val, masked, kind="random"):
    """Random round inputs on the card, the frontier bits random and
    given as words (``rows_to_words``). ``kind``: "random"; "high" puts
    half the columns near Q (so lane*Q + col and col*8 + lane pass 2^31
    when Q does 2^28); "junk" puts columns, parents and slots out of
    range, to hold the kernel's clamps to the plain version's;
    "narrow_miss" gives lanes 0 and 1 even parents and the bitmaps odd
    vertices only, so every undecided candidate misses the narrow lanes
    and is refetched; "none_survive" clears ``has_more``; "all_survive"
    leaves every job undecided, sets ``has_more`` and empties the
    bitmaps, so every candidate survives."""
    dev = "cuda"

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    junk = kind == "junk"
    cols = ri(-Q, 2 * Q, (C,)) if junk else ri(0, Q, (C,))
    if kind == "high":
        cols[::2] = Q - 1 - ri(0, min(Q, 1 << 24), (C - C // 2,))
    nb = (n_val + 9) // 8
    lo, hi = (-64, n_val + 512) if junk else (0, n_val + 1)
    tb = Q // 2 if junk else Q
    a = dict(
        cols=cols,
        undec=torch.rand((K, C), generator=gen, device=dev) < 0.7,
        has_more=torch.rand((C,), generator=gen, device=dev) < 0.6,
        pay0=ri(0, n_val, (C,)), pay1=ri(0, 8, (C,)),
        fbits=torch.rand((K, nb * 8), generator=gen, device=dev) < 0.15,
        tbits=(torch.randint(0, 256, (tb,), generator=gen, device=dev,
                             dtype=torch.uint8) if masked else None),
        dstT=ri(lo, hi, (8, Q)))
    if kind == "narrow_miss":
        a["dstT"][:2] &= -2
        a["fbits"][:, 0::2] = False
    elif kind == "none_survive":
        a["has_more"][:] = False
    elif kind == "all_survive":
        a["undec"][:] = True
        a["has_more"][:] = True
        a["fbits"][:] = False
    a["fbits"] = rows_to_words(pack_rows(a["fbits"]), K)
    return a


def opener_inputs(gen, g, K, masked):
    """A round shaped as the bottom-up opener makes it
    (``models/bfs_hybrid._bu_open``) on the device graph ``g``: the
    candidates are the unvisited vertices of degree > 0 in vertex order,
    so their columns rise and lie close together, followed by dead slots
    (column q_pad, no job) up to the next power of two; random frontier
    bits as words, and for K > 1 each job wanting most of the
    candidates."""
    from titan_tpu_torch.device import next_pow2
    dev = "cuda"
    n, dstT = g["n"], g["dstT"]
    q_pad = dstT.shape[1] - 1
    unvis = (torch.rand((n,), generator=gen, device=dev) < 0.6) \
        & (g["degc"][:n] > 0)
    cand = torch.nonzero(unvis).flatten().to(torch.int32)
    C = next_pow2(n)
    alive = torch.arange(C, device=dev) < cand.numel()
    v = torch.full((C,), n, dtype=torch.int32, device=dev)
    v[:cand.numel()] = cand
    undec = alive[None].repeat(K, 1)
    if K > 1:
        undec &= torch.rand((K, C), generator=gen, device=dev) < 0.8
    nb = (n + 9) // 8
    return dict(
        cols=torch.where(alive, g["colstart"][v.long()], q_pad),
        undec=undec, has_more=alive & (g["degc"][v.long()] > 1), pay0=v,
        pay1=torch.ones(C, dtype=torch.int32, device=dev),
        fbits=rows_to_words(pack_rows(torch.rand(
            (K, nb * 8), generator=gen, device=dev) < 0.15), K),
        tbits=(torch.randint(0, 256, (dstT.shape[1],), generator=gen,
                             device=dev, dtype=torch.uint8)
               if masked else None),
        dstT=dstT)


def call(fn, a, lanes, fill0=-7, fill1=-9):
    return fn(a["cols"], a["undec"], a["has_more"], a["pay0"], a["pay1"],
              a["fbits"], a["tbits"], a["dstT"], lanes=lanes, fill0=fill0,
              fill1=fill1)


def max_abs_err(got, ref) -> int:
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(got, ref))


def phase_kernel_cases(F, G) -> None:
    gen = torch.Generator(device="cuda").manual_seed(7)
    tile = F.kernel_library().tt_frontier_round_tile()
    # (K, lanes, tbits given, C, Q, n_val, kind)
    cases = [(K, lanes, masked, C, C + 31, 1 << 20, "random")
             for C in (70, 1 << 20) for K in (1, 3, 16, 17)
             for lanes in (2, 8)
             for masked in (False, True)]
    q_big = (1 << 28) + (1 << 24)          # 8*Q and Q*8 pass 2^31
    big = (3 << 22) + 4099                 # far more tiles than resident
    cases += [(1, 2, True, 1 << 20, q_big, 1 << 26, "high"),
              (1, 2, False, big, 1 << 22, 1 << 22, "random")]
    cases += [(5, lanes, True, 100003, 4099, 1000, "junk")
              for lanes in (2, 8)]
    m = 1 << 20
    cases += [(40, 2, True, 100003, 1 << 16, 1 << 16, "random"),  # 2 groups
              (1, 2, False, m, m, m, "narrow_miss"),
              (3, 2, True, m, m, m, "narrow_miss"),
              (2, 2, False, m, m, m, "none_survive"),
              (2, 8, True, m, m, m, "all_survive"),
              (2, 2, False, m, m, m, "all_survive"),
              (1, 2, False, 1, 31, 1000, "random"),
              (3, 8, True, 1, 31, 1000, "random"),
              (1, 2, False, 5 * tile + 1, m, m, "random"),
              (3, 8, True, 5 * tile + 1, m, m, "random")]
    cases += [(K, lanes, masked, None, None, None, "opener")
              for K, lanes, masked in ((1, 2, False), (3, 2, True),
                                       (1, 8, False))]
    hg = G.load_or_build(CASE_SCALE, EDGE_FACTOR, seed=SEED, verbose=False)
    g = G.graph_from_numpy(hg, "cuda")
    launches0 = F.frontier_round.launches
    k_total = p_total = 0.0
    for K, lanes, masked, C, Q, n_val, kind in cases:
        a = (opener_inputs(gen, g, K, masked) if kind == "opener" else
             round_inputs(gen, K, C, Q, n_val, masked, kind))
        C, Q = a["cols"].numel(), a["dstT"].shape[1]
        got = call(F.frontier_round, a, lanes)
        ref = call(F.frontier_round_reference, a, lanes)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        k_ms = cuda_ms(lambda: call(F.frontier_round, a, lanes), 5)
        p_ms = cuda_ms(lambda: call(F.frontier_round_reference, a, lanes), 2)
        what = {"random": "", "high": "columns near Q ",
                "junk": "out-of-range inputs ",
                "narrow_miss": "every candidate missing the narrow lanes ",
                "none_survive": "no survivors ",
                "all_survive": "every candidate a survivor ",
                "opener": f"opener columns of the s{CASE_SCALE} graph "}[kind]
        say(f"frontier_round K={K} lanes={lanes} "
            f"tbits={'given' if masked else 'none'} C={C} Q={Q} {what}"
            f"nsur={int(got[3])}: "
            f"{'bit-equal' if err == 0 else f'DIFFERS by {err}'}; "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        check(err == 0, "frontier_round differs from its plain version")
        check(round_bytes(a, lanes)["nsur"] == int(got[3]),
              "the byte model's survivor count differs from the kernel's")
        if kind == "all_survive":
            check(int(got[3]) == C, "not every candidate survived")
        if kind == "none_survive":
            check(int(got[3]) == 0, "a candidate survived")
        k_total, p_total = k_total + k_ms, p_total + p_ms
        del a, got, ref
    del g
    # back-to-back launches of the largest case: a stale status or a race
    # in the look-back would change a slot
    a = round_inputs(gen, 1, big, 1 << 22, 1 << 22, False)
    runs = [call(F.frontier_round, a, 2) for _ in range(REPEATS)]
    same = sum(all(torch.equal(x, y) for x, y in zip(r, runs[0]))
               for r in runs)
    say(f"frontier_round K=1 lanes=2 C={big}: {same}/{REPEATS} "
        f"back-to-back launches bit-equal to the first")
    check(same == REPEATS, "back-to-back frontier_round runs differ")
    del a, runs
    torch.cuda.empty_cache()
    n_cases = len(cases)
    say(f"phase 2: frontier_round bit-equal to its plain version in "
        f"{n_cases}/{n_cases} cases (tolerance 0: every output is "
        f"an integer) and run to run ({REPEATS} back-to-back launches), "
        f"tile {tile}, {F.frontier_round.launches - launches0} launches; "
        f"kernel {k_total:.4f} ms against plain {p_total:.4f} ms, summed "
        f"over one call of each case")


def exhaust_inputs(gen, K, P, Q, nv, c_cap, p_total, kind="random",
                   masked=False) -> dict:
    """Random sweep inputs on the card: frontier bits of density 0.02 as
    words; ``kind`` "random" (owners in sorted runs over [0, c_cap)),
    "hub" (one owner for every pair), "distinct" (each pair its own
    owner), "junk" (columns in [-Q, 2Q) and parents in [-64, nv+512), to
    hold the kernel's clamps to the plain version's). Pairs from
    ``p_total`` on are dead as ``enumerate_chunk_pairs`` lists them: the
    all-pad sink column Q - 1, whose parents are the pad vertex nv + 1,
    which no job holds."""
    dev = "cuda"

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    junk = kind == "junk"
    bits = torch.rand((K, ((nv + 9) // 8) * 8), generator=gen,
                      device=dev) < 0.02
    bits[:, nv + 1] = False
    dstT = ri(-64, nv + 512, (8, Q)) if junk else ri(0, nv + 2, (8, Q))
    dstT[:, Q - 1] = nv + 1
    cols = ri(-Q, 2 * Q, (P,)) if junk else ri(0, Q - 1, (P,))
    cols[p_total:] = Q - 1
    if kind == "hub":
        owner = torch.zeros(P, dtype=torch.int32, device=dev)
    elif kind == "distinct":
        owner = torch.arange(P, dtype=torch.int32, device=dev)
    else:
        owner = torch.sort(ri(0, c_cap, (P,))).values
    return dict(cols=cols, owner=owner,
                p_total=torch.tensor(p_total, dtype=torch.int32, device=dev),
                fbits=rows_to_words(pack_rows(bits), K),
                tbits=(torch.randint(0, 256, (Q,), generator=gen,
                                     device=dev, dtype=torch.uint8)
                       if masked else None),
                dstT=dstT, K=K, c_cap=c_cap)


def phase_exhaust_cases(F) -> None:
    """``batched_exhaust``'s kernel against its plain version on the card,
    bit-equal, then back-to-back launches each bit-equal to the first."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    m = 1 << 20
    # (K, P, Q, nv, c_cap, p_total, kind, tbits given, what)
    cases = [(K, m, m, m, 1 << 16, m - 12345, "random", False, "")
             for K in (1, 3, 16, 40)]
    cases += [(16, m, m, m, 1 << 16, m - 99, "random", True, "tbits "),
              (16, 1 << 22, m, m, 1 << 10, (1 << 22) - 7, "hub", False,
               "one owner over 2^17 warps "),
              (16, m, m, m, m, m, "distinct", False,
               "each pair its own owner "),
              (3, 1 << 16, 4099, 1000, 512, 0, "random", False,
               "p_total 0 "),
              (3, 1 << 16, 4099, 1000, 512, 1, "random", False,
               "p_total 1 "),
              (5, 100003, 4099, 1000, 4096, 90001, "junk", True,
               "out-of-range columns and parents "),
              (16, 100003, 4099, 1000, 4096, 100003, "junk", False,
               "out-of-range columns and parents, every pair live ")]
    launches0 = F.batched_exhaust.launches
    k_total = p_total = 0.0
    for K, P, Q, nv, c_cap, pt, kind, masked, what in cases:
        e = exhaust_inputs(gen, K, P, Q, nv, c_cap, pt, kind, masked)
        got = exhaust_call(F.batched_exhaust, e)
        ref = exhaust_call(F.batched_exhaust_reference, e)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        k_ms = cuda_ms(lambda: exhaust_call(F.batched_exhaust, e), 5)
        p_ms = cuda_ms(lambda: exhaust_call(F.batched_exhaust_reference, e),
                       2)
        say(f"batched_exhaust K={K} P={P} p_total={pt} c_cap={c_cap} "
            f"{what}({int(got.sum())} candidate bits found): "
            f"{'bit-equal' if same else 'DIFFERS'}; kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms")
        check(same, "batched_exhaust differs from its plain version")
        if pt == 0:
            check(not got.any(), "p_total 0 found a candidate")
        k_total, p_total = k_total + k_ms, p_total + p_ms
        del e, got, ref
    for K, P, Q, nv, c_cap, pt, kind, masked, _ in (cases[5], cases[3]):
        e = exhaust_inputs(gen, K, P, Q, nv, c_cap, pt, kind, masked)
        runs = [exhaust_call(F._launch_exhaust, e) for _ in range(REPEATS)]
        same = sum(torch.equal(r, runs[0]) for r in runs)
        say(f"batched_exhaust K={K} P={P} ({kind}): {same}/{REPEATS} "
            f"back-to-back launches bit-equal to the first")
        check(same == REPEATS, "back-to-back batched_exhaust runs differ")
        del e, runs
    torch.cuda.empty_cache()
    say(f"phase 2: batched_exhaust bit-equal to its plain version in "
        f"{len(cases)}/{len(cases)} cases (tolerance 0: bits) and run to "
        f"run ({REPEATS} back-to-back launches of the hub and the K = 40 "
        f"cases), {F.batched_exhaust.launches - launches0} launches; "
        f"kernel {k_total:.4f} ms against plain {p_total:.4f} ms, summed "
        f"over one call of each case")


def hub_flags(seed: int, e: int, tile: int):
    """Hub-like segment starts on the card: segments spanning 2-300 tiles,
    each followed by a run of 1-8 tiles of short segments (a start every
    32 elements on average)."""
    rng = np.random.default_rng(seed)
    flags = rng.random(e) < 1 / 32
    pos = int(rng.integers(0, tile))
    while pos < e:
        span = int(rng.integers(2 * tile, 300 * tile + 1))
        flags[pos] = True
        flags[pos + 1:pos + span] = False
        pos += span
        if pos < e:
            flags[pos] = True
        pos += int(rng.integers(tile, 8 * tile + 1))
    return torch.from_numpy(flags).cuda()


def seg_inputs(gen, e: int, dtype, density, first: bool = True,
               tile: int = 0):
    """Random scan inputs on the card: values uniform in [-1, 1) or over
    the whole int32 range, segment starts with ``density`` (or hub-like
    ones, ``hub_flags``, when it is "hubs"), and ``flags[0]`` set to
    ``first``."""
    if dtype == torch.float32:
        values = torch.rand((e,), generator=gen, device="cuda") * 2 - 1
    else:
        values = torch.randint(-2**31, 2**31, (e,), generator=gen,
                               device="cuda", dtype=torch.int32)
    if density == "hubs":
        flags = hub_flags(int(torch.randint(0, 2**31, (), generator=gen,
                                            device="cuda")), e, tile)
    else:
        flags = torch.rand((e,), generator=gen, device="cuda") < density
    flags[0] = first
    return values, flags


def scan_error(S, got, ref, values, flags, combine) -> float:
    """max |got - ref|; raises unless exact, or, for float32 sums, within
    FLOAT_SUM_RTOL of the scan of |values| at every position."""
    err = float((got.double() - ref.double()).abs().max())
    if combine == "sum" and values.dtype == torch.float32:
        scale = S.seg_scan_reference(values.abs(), flags, "sum")
        ok = bool(((got - ref).abs() <= FLOAT_SUM_RTOL * scale).all())
    else:
        ok = bool(torch.equal(got, ref))
    check(ok, f"seg_scan {combine} {values.dtype} E={values.numel()} "
          f"differs from its plain version by {err}")
    return err


def phase_seg_scan_cases(S) -> None:
    gen = torch.Generator(device="cuda").manual_seed(11)
    tile = S.kernel_library().tt_seg_scan_tile()
    big = (3 << 22) + 4099
    cases = [(e, d, True, "random starts") for e, d in (
        (1, 0.5), (70, 0.2), (tile - 1, 0.01), (tile, 0.01),
        (tile + 1, 0.01), (1 << 20, 1e-3), (big, 1e-5))]
    one, hubs = ((big, 0.0, False, "one segment spanning every tile"),
                 (big, "hubs", True, "hub-like segments spanning 2-300 "
                                     "tiles"))
    cases += [one, hubs, (big, 1.0, True, "every element its own segment"),
              (1 << 20, 1e-3, False, "flags[0] False")]
    launches0 = S.seg_scan.launches
    k_total = p_total = 0.0
    n_cases = 0
    for dtype in (torch.float32, torch.int32):
        for combine in S.COMBINES:
            for e, density, first, what in cases:
                values, flags = seg_inputs(gen, e, dtype, density, first,
                                           tile)
                got = S.seg_scan(values, flags, combine)
                ref = S.seg_scan_reference(values, flags, combine)
                err = scan_error(S, got, ref, values, flags, combine)
                k_ms = cuda_ms(lambda: S.seg_scan(values, flags, combine), 5)
                p_ms = cuda_ms(lambda: S.seg_scan_reference(values, flags,
                                                            combine), 2)
                again = S.seg_scan(values, flags, combine)
                check(torch.equal(got, again), "two seg_scan runs differ")
                if e >= big:
                    say(f"seg_scan {combine} {str(dtype)[6:]} E={e} "
                        f"({what}): max_abs_err {err:.3g}; kernel "
                        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms")
                k_total, p_total = k_total + k_ms, p_total + p_ms
                n_cases += 1
                del values, flags, got, ref, again
    for e, density, first, what in (one, hubs):
        values, flags = seg_inputs(gen, e, torch.float32, density, first,
                                   tile)
        runs = [S.seg_scan(values, flags, "sum") for _ in range(REPEATS)]
        same = sum(torch.equal(r, runs[0]) for r in runs)
        say(f"seg_scan sum float32 E={e} ({what}): {same}/{REPEATS} "
            f"back-to-back launches bit-equal to the first")
        check(same == REPEATS, "back-to-back seg_scan runs differ")
        del values, flags, runs
    torch.cuda.empty_cache()
    say(f"phase 3: seg_scan agrees with its plain version in "
        f"{n_cases}/{n_cases} cases (min, max and int32 sums exact; "
        f"float32 sums within {FLOAT_SUM_RTOL:g} of the scan of |x|), "
        f"bit-equal run to run ({REPEATS} back-to-back float32 sums twice), "
        f"tile {tile}, {S.seg_scan.launches - launches0} launches; kernel "
        f"{k_total:.4f} ms against plain {p_total:.4f} ms, summed over one "
        f"call of each case")


#: the K-row scan's cases: K jobs, E below a tile, odd across tiles,
#: E = 2 mod 4 (the s22 engine's: its odd rows start 8 bytes off 16 when
#: ld = E), and the hub-like starts over E = 2 mod 4
ROW_KS = (1, 3, 16)


def row_inputs(gen, k: int, e: int, ld: int, dtype, density, tile: int):
    """K rows of random scan inputs ([k, ld]; columns past E hold values
    the scan must not read) under one flag array [E]."""
    values, _ = seg_inputs(gen, k * ld, dtype, 0.0)
    _, flags = seg_inputs(gen, e, dtype, density, True, tile)
    return values.view(k, ld), flags


def phase_seg_scan_rows(S) -> None:
    """The K-row launch: every row bit-equal to the one-row launch on that
    row (a contiguous copy, so 16-byte aligned), the whole against the
    plain version (exact, float32 sums within FLOAT_SUM_RTOL); then
    REPEATS back-to-back launches of the largest hub case, each bit-equal
    to the first."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    tile = S.kernel_library().tt_seg_scan_tile()
    shapes = [(70, 0.2, "below a tile"), (5 * tile + 1, 0.01, "odd"),
              ((1 << 20) + 2, 1e-3, "2 mod 4"),
              ((1 << 22) + 2, "hubs", "2 mod 4, hub-like starts")]
    launches0 = S.seg_scan.launches
    n_cases = 0
    for k in ROW_KS:
        for e, density, what in shapes:
            for ld in (e, e + 4 - e % 4):
                for dtype in (torch.float32, torch.int32):
                    for combine in S.COMBINES:
                        values, flags = row_inputs(gen, k, e, ld, dtype,
                                                   density, tile)
                        got = S.seg_scan(values, flags, combine)
                        check(tuple(got.shape) == (k, e),
                              f"K-row seg_scan shape {tuple(got.shape)}")
                        for r in range(k):
                            one = S.seg_scan(values[r, :e].contiguous(),
                                             flags, combine)
                            check(torch.equal(got[r], one),
                                  f"K-row seg_scan {combine} {dtype} K={k} "
                                  f"E={e} ld={ld} ({what}): row {r} differs "
                                  "from the one-row launch")
                        ref = S.seg_scan_reference(values, flags, combine)
                        scan_error(S, got, ref, values[:, :e], flags,
                                   combine)
                        n_cases += 1
                        del values, flags, got, ref
    e = shapes[-1][0]
    values, flags = row_inputs(gen, ROW_KS[-1], e, e, torch.float32,
                               "hubs", tile)
    runs = [S.seg_scan(values, flags, "sum") for _ in range(REPEATS)]
    same = sum(torch.equal(r, runs[0]) for r in runs)
    check(same == REPEATS, "back-to-back K-row seg_scan runs differ")
    del values, flags, runs
    torch.cuda.empty_cache()
    say(f"phase 3: K-row seg_scan (K in {ROW_KS}, E in "
        f"{[sh[0] for sh in shapes]}, ld = E and padded to 4, both types, "
        f"every combine): {n_cases}/{n_cases} cases, every row bit-equal to "
        f"the one-row launch and the whole to the plain version (float32 "
        f"sums within {FLOAT_SUM_RTOL:g}); {same}/{REPEATS} back-to-back "
        f"K={ROW_KS[-1]} float32 sums over E={e} (hubs) bit-equal to the "
        f"first; {S.seg_scan.launches - launches0} launches")


def sample_sources(deg, k: int):
    """bench.py's rule: distinct sources of degree > 0, default_rng(12345)."""
    rng = np.random.default_rng(12345)
    nonzero = np.flatnonzero(np.asarray(deg) > 0)
    return [int(s) for s in rng.choice(nonzero, size=min(k, len(nonzero)),
                                       replace=False)]


#: BFS thresholds that send every level past the head's first through the
#: top-down steps and the bottom-up rounds: below 2^21 vertices the
#: endgame would otherwise finish the whole search
FORCE_BU = {"END_C_CAP": 0, "END_P_CAP": 0, "HEAD_F_CAP": 1}


def phase_small(F, P, G) -> None:
    hg = G.load_or_build(SMALL_SCALE, EDGE_FACTOR, seed=SEED, verbose=False)
    g_gpu = G.graph_from_numpy(hg, "cuda")
    g_cpu = G.graph_from_numpy(hg, "cpu")
    default = {k: getattr(P, k) for k in FORCE_BU}
    for forced in (False, True):
        for k, v in (FORCE_BU if forced else default).items():
            setattr(P, k, v)
        F.frontier_round.launches = 0
        for src in sample_sources(hg["deg"], 2):
            d_gpu, lv_gpu = P.frontier_bfs_hybrid(g_gpu, src)
            d_cpu, lv_cpu = P.frontier_bfs_hybrid(g_cpu, src, device="cpu")
            check(np.array_equal(d_gpu, d_cpu) and lv_gpu == lv_cpu,
                  f"s{SMALL_SCALE} source {src} (forced bottom-up: "
                  f"{forced}): CUDA BFS differs from CPU BFS")
        launches = F.frontier_round.launches
        say(f"phase 4: s{SMALL_SCALE} CUDA BFS equals the CPU BFS "
            f"(2 sources, {lv_gpu} levels, forced bottom-up: {forced}), "
            f"frontier_round launches {launches}")
    for k, v in default.items():
        setattr(P, k, v)
    check(launches > 0, "the CUDA BFS never launched frontier_round")


def timed(fn):
    """(fn(), seconds by CUDA events around the call)."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1) / 1e3


def wall_s(fn):
    """(fn(), host seconds around the call, the card synchronised)."""
    torch.cuda.synchronize()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t


def host_pagerank(snap, alpha: float, iterations: int):
    """Float64 PageRank on the host with scipy.sparse over the snapshot's
    edges, by models/pagerank.py's formula."""
    import scipy.sparse as sp
    n = snap.n
    a = sp.csr_matrix((np.ones(snap.num_edges), snap.src, snap.indptr_in),
                      shape=(n, n))
    deg = snap.out_degree.astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    rank = np.full(n, 1.0 / n)
    for _ in range(iterations):
        rank = (1.0 - alpha) / n + alpha * (a @ (rank * inv))
    return rank


def min_label_components(snap) -> np.ndarray:
    """Each vertex's smallest vertex id in its component (scipy)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    n = snap.n
    a = sp.csr_matrix((np.ones(snap.num_edges, np.int8), snap.src,
                       snap.indptr_in), shape=(n, n))
    _, comp = connected_components(a, directed=True, connection="weak")
    _, first = np.unique(comp, return_index=True)   # lowest id of each
    return first[comp].astype(np.int32)


def seg_scan_replay(S, SG, g, msg, n, deg) -> dict:
    """The widest main-path call, one PageRank superstep's [E] messages:
    agreement with the plain version, times, the byte bound, and
    torch.segment_reduce (the same combine, scan and gather, in one
    PyTorch call) timed beside the port's combine. Also, at the same
    flags, the int32 ``min`` of BFS and WCC over random labels (exact
    against the plain version) and a plain ``copy_`` of the messages,
    the rate the card reaches for traffic with no dependences."""
    got = S.seg_scan(msg, g.flags, "sum")
    ref = S.seg_scan_reference(msg, g.flags, "sum")
    err = scan_error(S, got, ref, msg, g.flags, "sum")
    ms = cuda_ms(lambda: S.seg_scan(msg, g.flags, "sum"), 20, warmup=2)
    plain_ms = cuda_ms(lambda: S.seg_scan_reference(msg, g.flags, "sum"), 3)
    del got, ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    labels = torch.randint(0, n, msg.shape, generator=gen, device="cuda",
                           dtype=torch.int32)
    scan_error(S, S.seg_scan(labels, g.flags, "min"),
               S.seg_scan_reference(labels, g.flags, "min"), labels,
               g.flags, "min")
    min_ms = cuda_ms(lambda: S.seg_scan(labels, g.flags, "min"), 20,
                     warmup=2)
    dst = torch.empty_like(msg)
    copy_ms = cuda_ms(lambda: dst.copy_(msg), 20, warmup=2)
    del labels, dst

    def combine():
        return SG.segment_combine(msg, g.dst, n, "sum", last_idx=g.last_idx,
                                  seg_has=g.seg_has, flags=g.flags)
    lengths = torch.from_numpy(deg.astype(np.int64)).cuda()

    def library():
        return torch.segment_reduce(msg, "sum", lengths=lengths, unsafe=True)
    check(torch.allclose(combine(), library(), rtol=FLOAT_SUM_RTOL,
                         atol=0.0), "segment_combine and "
          "torch.segment_reduce disagree")
    combine_ms = cuda_ms(combine, 10, warmup=2)
    library_ms = cuda_ms(library, 10, warmup=2)
    e = msg.numel()
    nbytes = e * (msg.element_size() + 1 + msg.element_size())
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"E": e, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "combine_ms": combine_ms, "library_ms": library_ms,
            "bytes": nbytes, "bound_ms": bound_ms, "share": bound_ms / ms,
            "min_ms": min_ms, "copy_ms": copy_ms,
            "copy_bytes": 2 * e * msg.element_size()}


def superstep_parts(SG, g, rank, inv_outdeg, n) -> dict:
    """Device ms of each part of one PageRank superstep at these inputs."""
    from titan_tpu_torch.models.pagerank import PageRank
    prog = PageRank(0.85, 20, 0.0)
    state = {"rank": rank, "inv_outdeg": inv_outdeg}
    params = {"n": torch.tensor(n, dtype=torch.int32, device="cuda")}
    src_state = {k: v.index_select(0, g.src) for k, v in state.items()}
    msg = prog.message(src_state, {}, params)
    agg = SG.segment_combine(msg, g.dst, n, "sum", last_idx=g.last_idx,
                             seg_has=g.seg_has, flags=g.flags)
    return {
        "gather": cuda_ms(lambda: [v.index_select(0, g.src)
                                   for v in state.values()], 10),
        "message": cuda_ms(lambda: prog.message(src_state, {}, params), 10),
        "combine": cuda_ms(lambda: SG.segment_combine(
            msg, g.dst, n, "sum", last_idx=g.last_idx, seg_has=g.seg_has,
            flags=g.flags), 10),
        "apply": cuda_ms(lambda: prog.apply(state, agg, 0, params), 10)}


def engine_references(host_build) -> dict:
    """Host side of the engine phase, run while the s26 build still
    occupies the host: the s22 snapshot (from_chunked_csr) and the
    float64 PageRank and component labels that phase 5 checks against."""
    from titan_tpu_torch.olap import snapshot as SN

    hg, build_s = host_build.result()
    t0 = time.time()
    snap = SN.from_chunked_csr(hg)
    snap_s = time.time() - t0
    t0 = time.time()
    ref = {"hg": hg, "snap": snap, "pagerank": host_pagerank(snap, 0.85, 20),
           "labels": min_label_components(snap)}
    say(f"phase 5: s{ENGINE_SCALE} ef{EDGE_FACTOR} host build {build_s:.1f} "
        f"s, from_chunked_csr {snap_s:.1f} s: {snap.n} vertices, "
        f"{snap.num_edges} directed edges (symmetric, deduplicated); "
        f"float64 scipy PageRank and components {time.time() - t0:.1f} s")
    return ref


def phase_engine(S, P, G, ref, card) -> dict:
    """The engine's main path at s22: PageRank, BFS and WCC through
    GPUGraphComputer.run, then checks, the replay and the parts."""
    from titan_tpu_torch.device import INF
    from titan_tpu_torch.models import bfs as MB
    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.models import wcc as MW
    from titan_tpu_torch.olap import engine as E
    from titan_tpu_torch.ops import segment as SG

    hg, snap = ref["hg"], ref["snap"]
    comp = E.GPUGraphComputer(snapshot=snap)
    t0 = time.time()
    g = E.device_graph(snap, comp.device)
    torch.cuda.synchronize()
    say(f"phase 5: upload {time.time() - t0:.1f} s")
    n = snap.n
    src0 = sample_sources(hg["deg"], 1)[0]
    real, captured = E.segment_combine, {}

    def capture(msg, *args, **kw):        # keeps the last superstep's [E]
        captured["msg"] = msg
        return real(msg, *args, **kw)

    # ---- the main path, with the kernel counts from 0
    S.seg_scan.launches = 0
    E.segment_combine = capture
    try:
        _, warm_s = timed(lambda: MP.run(comp, 0.85, 20, 0.0, snap))
    finally:
        E.segment_combine = real
    pr, pr_s = timed(lambda: MP.run(comp, 0.85, 20, 0.0, snap))
    bfs, bfs_s = timed(lambda: MB.run(comp, src0, snapshot=snap))
    wcc, wcc_s = timed(lambda: MW.run(comp, snapshot=snap))
    launches = S.seg_scan.launches
    # ---- end of the main path
    check(launches > 0, "the engine never launched seg_scan")
    check(pr.iterations == 20, f"PageRank ran {pr.iterations} supersteps")
    say(f"phase 5: PageRank {pr.iterations} supersteps in {pr_s:.4f} s "
        f"({pr_s / pr.iterations * 1e3:.4f} ms a superstep, CUDA events "
        f"over GPUGraphComputer.run, upload excluded, init and the ranks' "
        f"readback included; the first run took {warm_s:.4f} s); BFS "
        f"from {src0}: {bfs.iterations} supersteps in {bfs_s:.4f} s; WCC "
        f"{wcc.iterations} supersteps in {wcc_s:.4f} s; seg_scan launches "
        f"{launches} over the 4 runs")

    rel = float(np.max(np.abs(pr["rank"] - ref["pagerank"])
                       / ref["pagerank"]))
    check(rel <= PAGERANK_RTOL, f"PageRank differs from float64 by {rel}")
    ref["engine_rank"] = pr["rank"]       # phase 10's dense jobs match it
    g500 = G.graph_from_numpy(hg, "cuda")
    dist, levels = P.frontier_bfs_hybrid(g500, src0)
    check(np.array_equal(bfs["dist"], dist), "the engine's BFS differs "
          "from frontier_bfs_hybrid")
    label = wcc["label"]
    check(np.array_equal(label, ref["labels"]), "a WCC label is not the "
          "smallest vertex id of its component")
    reached = bfs["dist"] < INF
    check(bool((label[reached] == label[src0]).all()), "the vertices BFS "
          "reached do not share one WCC label")
    say(f"phase 5: PageRank within {rel:.3g} of float64 scipy (tolerance "
        f"{PAGERANK_RTOL:g}, max relative error); BFS dist equals "
        f"frontier_bfs_hybrid ({levels} levels, {int(reached.sum())} "
        f"reached); WCC labels are the smallest id of each scipy "
        f"component ({len(np.unique(label))} components) and BFS's reached "
        f"set shares one")
    del g500

    deg = np.diff(snap.indptr_in)
    rec = seg_scan_replay(S, SG, g, captured.pop("msg"), n, deg)
    parts = superstep_parts(
        SG, g, torch.from_numpy(pr["rank"]).cuda(),
        torch.from_numpy(np.where(snap.out_degree > 0, 1.0 / np.maximum(
            snap.out_degree, 1), 0.0).astype(np.float32)).cuda(), n)
    say(f"phase 5: widest seg_scan call (a PageRank superstep's messages, "
        f"E={rec['E']}): max_abs_err {rec['max_abs_err']:.3g} (float32 "
        f"sum, within {FLOAT_SUM_RTOL:g} of the scan of |x|); kernel "
        f"{rec['ms']:.4f} ms (mean of 20), plain {rec['plain_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bytes']} bytes at 3.35 "
        f"TB/s: values and flags read once, out written once), "
        f"{100 * rec['share']:.1f}% of the bound, "
        f"{rec['bytes'] / rec['ms'] / 1e9:.3f} TB/s; the whole "
        f"combine {rec['combine_ms']:.4f} ms against torch.segment_reduce "
        f"{rec['library_ms']:.4f} ms")
    say(f"phase 5: at the same flags, seg_scan min int32 (BFS's and WCC's "
        f"combine, random labels): exact; {rec['min_ms']:.4f} ms (mean of "
        f"20), {100 * rec['bound_ms'] / rec['min_ms']:.1f}% of the bound; a "
        f"plain copy_ of the messages {rec['copy_ms']:.4f} ms, "
        f"{rec['copy_bytes'] / rec['copy_ms'] / 1e9:.3f} TB/s")
    say(f"phase 5: one PageRank superstep on {card}, device ms: "
        + json.dumps(parts))
    return {**SEG_KERNEL, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": "bytes", "library_ms": rec["library_ms"]}, \
        pr_s / pr.iterations


#: the batched PageRank of phase 5b
PR_BATCH = 4
#: the checkpoint cadence of phase 5c's 20-superstep PageRank
CKPT_EVERY = 5


def row_scan_replay(S, values, flags, combine: str, deg=None) -> dict:
    """The widest K-row call of a batched run, ``values`` [K, ld]: every
    row bit-equal to the one-row launch, the plain version row by row
    (exact, float32 sums within FLOAT_SUM_RTOL), times, the two byte
    bounds (flags read once; flags read again for each row, since 50 MB
    of L2 cannot keep them), and, for float32 (``deg`` given),
    torch.segment_reduce over the K rows (axis 1) timed beside the scan.
    torch.segment_reduce takes no int32, so the int32 call has none."""
    k, e = values.shape[0], flags.shape[0]
    got = S.seg_scan(values, flags, combine)
    err = 0.0
    for r in range(k):
        row = values[r, :e].contiguous()
        check(torch.equal(got[r], S.seg_scan(row, flags, combine)),
              f"K-row seg_scan row {r} differs from the one-row launch")
        err = max(err, scan_error(S, got[r], S.seg_scan_reference(
            row, flags, combine), row, flags, combine))
        del row
    del got
    ms = cuda_ms(lambda: S.seg_scan(values, flags, combine), 10, warmup=2)
    plain_ms = cuda_ms(lambda: [S.seg_scan_reference(values[r, :e], flags,
                                                     combine)
                                for r in range(k)], 1)
    size = values.element_size()
    nbytes = 2 * size * k * e + e
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    reread_ms = (2 * size + 1) * k * e / HBM_BYTES_PER_S * 1e3
    rec = {"K": k, "E": e, "ld": values.shape[1],
           "dtype": str(values.dtype)[6:], "combine": combine,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bytes": nbytes, "bound_ms": bound_ms, "share": bound_ms / ms,
           "bound_ms_flags_per_row": reread_ms,
           "share_flags_per_row": reread_ms / ms, "library_ms": None}
    if deg is not None:
        data = values[:, :e].contiguous()
        lengths = torch.from_numpy(np.tile(deg.astype(np.int64),
                                           (k, 1))).cuda()

        def library():
            return torch.segment_reduce(data, combine, lengths=lengths,
                                        axis=1, unsafe=True)
        lib = library()
        check(lib.shape == (k, deg.shape[0]), "segment_reduce shape")
        rec["library_ms"] = cuda_ms(library, 5, warmup=1)
        del data, lengths, lib
    return rec


def say_rows(name: str, r: dict, card: str) -> None:
    say(f"phase 5b: widest K-row seg_scan of the {name} (K={r['K']}, "
        f"E={r['E']}, ld={r['ld']}, {r['dtype']} {r['combine']}) on {card}: "
        f"every row bit-equal to the one-row launch, max_abs_err against "
        f"the plain version {r['max_abs_err']:.3g}; kernel {r['ms']:.4f} "
        f"ms (mean of 10), plain {r['plain_ms']:.4f} ms; bound "
        f"{r['bound_ms']:.4f} ms ({r['bytes']} bytes at 3.35 TB/s, flags "
        f"once), {100 * r['share']:.1f}% of it; with the flags read again "
        f"for each row {r['bound_ms_flags_per_row']:.4f} ms, "
        f"{100 * r['share_flags_per_row']:.1f}%; torch.segment_reduce "
        f"(axis 1) " + ("takes no int32" if r["library_ms"] is None
                        else f"{r['library_ms']:.4f} ms"))


def phase_engine_batched(S, P, G, ref, card) -> dict:
    """Phase 5b on phase 5's s22 snapshot: GPUGraphComputer.run_batched
    for K = 16 BFS sources (bench.py's rule), each row's dist and
    iterations equal to GPUGraphComputer.run from that source and dist
    equal to frontier_bfs_hybrid; K = 4 PageRank jobs, each row bit-equal
    to the single run's ranks; the walls, the peak memory, the launches
    and the widest K-row scan of each replayed against its bounds."""
    from titan_tpu_torch.models import bfs as MB
    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.olap import engine as E

    hg, snap = ref["hg"], ref["snap"]
    comp = E.GPUGraphComputer(snapshot=snap)
    n = snap.n
    srcs = sample_sources(hg["deg"], BATCH_K)
    real, captured = E.sorted_segment_combine, {}

    def capture(values, *args, **kw):     # the run's [K, ld] messages
        captured["values"] = values
        return real(values, *args, **kw)

    # ---- the main path: the batched BFS, counts from 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    S.seg_scan.launches = 0
    E.sorted_segment_combine = capture
    try:
        bres, bfs_s = wall_s(lambda: comp.run_batched(
            MB.BFS(), [{"source_dense": s} for s in srcs]))
    finally:
        E.sorted_segment_combine = real
    launches_bfs = S.seg_scan.launches
    # ---- end of the main path
    check(launches_bfs > 0, "the batched BFS never launched seg_scan")
    bfs_peak = torch.cuda.max_memory_allocated()
    singles, singles_s = wall_s(lambda: [MB.run(comp, s, snapshot=snap)
                                         for s in srcs])
    g500 = G.graph_from_numpy(hg, "cuda")
    for s, b, one in zip(srcs, bres, singles):
        check(b.iterations == one.iterations and np.array_equal(
            b["dist"], one["dist"]), f"batched BFS row of source {s} "
              "differs from GPUGraphComputer.run")
        dist, _ = P.frontier_bfs_hybrid(g500, s)
        check(np.array_equal(b["dist"], dist), f"batched BFS row of source "
              f"{s} differs from frontier_bfs_hybrid")
        ref.setdefault("bfs_rows", {})[s] = dist    # phase 10's references
    del g500
    say(f"phase 5b: s{ENGINE_SCALE} run_batched(BFS, K={BATCH_K}) on "
        f"{card}: {bfs_s:.4f} s wall (the {BATCH_K} single runs "
        f"{singles_s:.4f} s), supersteps {[b.iterations for b in bres]}, "
        f"every row's dist and iterations equal to GPUGraphComputer.run "
        f"and dist to frontier_bfs_hybrid; seg_scan launches "
        f"{launches_bfs}; peak memory {bfs_peak / 2**30:.3f} GiB")
    rows = [row_scan_replay(S, captured.pop("values"), E.device_graph(
        snap, comp.device).flags, "min")]
    say_rows("BFS batch", rows[0], card)
    del bres, singles
    torch.cuda.empty_cache()

    prog = MP.PageRank(0.85, 20, 0.0)
    inv = np.where(snap.out_degree > 0, 1.0 / np.maximum(
        snap.out_degree, 1), 0.0).astype(np.float32)
    params = {"n": n, "inv_outdeg": inv}
    # ---- the main path: the batched PageRank, counts from 0
    torch.cuda.reset_peak_memory_stats()
    S.seg_scan.launches = 0
    E.sorted_segment_combine = capture
    try:
        pres, pr_s = wall_s(lambda: comp.run_batched(prog,
                                                     [params] * PR_BATCH))
    finally:
        E.sorted_segment_combine = real
    launches_pr = S.seg_scan.launches
    # ---- end of the main path
    check(launches_pr > 0, "the batched PageRank never launched seg_scan")
    pr_peak = torch.cuda.max_memory_allocated()
    one, one_s = wall_s(lambda: comp.run(prog, params))
    for j, r in enumerate(pres):
        check(r.iterations == one.iterations == 20 and np.array_equal(
            r["rank"], one["rank"]), f"batched PageRank row {j} is not "
              "bit-equal to the single run")
    say(f"phase 5b: s{ENGINE_SCALE} run_batched(PageRank, K={PR_BATCH}, 20 "
        f"supersteps) on {card}: {pr_s:.4f} s wall (one single run "
        f"{one_s:.4f} s), every row bit-equal to the single run; seg_scan "
        f"launches {launches_pr}; peak memory {pr_peak / 2**30:.3f} GiB")
    rows.append(row_scan_replay(S, captured.pop("values"), E.device_graph(
        snap, comp.device).flags, "sum", deg=np.diff(snap.indptr_in)))
    say_rows("PageRank batch", rows[1], card)
    del pres
    torch.cuda.empty_cache()
    return {"launches": launches_bfs + launches_pr, "rows": rows,
            "bfs_s": bfs_s, "pagerank_s": pr_s, "bfs_peak": bfs_peak,
            "pagerank_peak": pr_peak}


def phase_checkpoint(S, ref, card) -> int:
    """Phase 5c on phase 5's s22 snapshot: PageRank, 20 supersteps,
    checkpointed every CKPT_EVERY into a directory of the checkout
    (``.bench_cache/``, ignored): bit-equal to the run without
    checkpoints; the round-15 and round-20 checkpoints removed, the
    resumed run bit-equal; the newest remaining one corrupted, ``latest``
    falls back to round 5 and the resumed run is bit-equal again. Then a
    classic MapReduce, a histogram of the in-degrees an InDegree program
    computes through seg_scan, against numpy. Returns the seg_scan
    launches of the checkpointed, resumed and MapReduce runs."""
    import os
    import shutil

    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.olap import engine as E
    from titan_tpu_torch.olap.api import DenseProgram, MapReduce
    from titan_tpu_torch.olap.recovery import CheckpointStore, FaultPlan

    class InDegree(DenseProgram):
        combine = "sum"
        max_iterations = 1

        def init(self, n, params):
            return {"deg": torch.zeros((n,), dtype=torch.int32)}

        def message(self, src_state, edge_data, params):
            return torch.ones_like(src_state["deg"])

        def apply(self, state, agg, iteration, params):
            return {"deg": agg}

    class DegreeHistogram(MapReduce):
        memory_key = "degrees"

        def map(self, vertex, emitter):
            emitter.emit(vertex.value("deg"), 1)

        def combine(self, key, values, emitter):
            emitter.emit(key, sum(values))

        def reduce(self, key, values, emitter):
            emitter.emit(key, sum(values))

        def finalize(self, results):
            return {k: v[0] for k, v in results.items()}

    snap = ref["snap"]
    comp = E.GPUGraphComputer(snapshot=snap)
    prog = MP.PageRank(0.85, 20, 0.0)
    params = {"n": snap.n, "inv_outdeg": np.where(
        snap.out_degree > 0, 1.0 / np.maximum(snap.out_degree, 1),
        0.0).astype(np.float32)}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_cache", "smoke_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    plain = comp.run(prog, params)
    # ---- the checkpoint path, counts from 0
    S.seg_scan.launches = 0
    full, full_s = wall_s(lambda: comp.run(prog, params, checkpoint_to=root,
                                           checkpoint_every=CKPT_EVERY))
    store = CheckpointStore(root)
    paths = store.checkpoints("run")
    names = [os.path.basename(p) for p in paths]
    check(names == [f"ckpt-a0001-r{r:08d}" for r in (5, 10, 15, 20)],
          f"checkpoints {names}")
    check(full.iterations == 20 and np.array_equal(full["rank"],
                                                   plain["rank"]),
          "the checkpointed PageRank differs from the uncheckpointed run")
    for p in paths[2:]:
        shutil.rmtree(p)
    res1, res1_s = wall_s(lambda: comp.run(prog, params, resume_from=root))
    check(res1.iterations == 20 and np.array_equal(res1["rank"],
                                                   full["rank"]),
          "PageRank resumed from round 10 differs")
    FaultPlan.corrupt(paths[1])
    check(store.latest("run").round == 5, "latest() did not fall back to "
          "round 5 past the corrupted round 10")
    res2 = comp.run(prog, params, resume_from=root)
    check(res2.iterations == 20 and np.array_equal(res2["rank"],
                                                   full["rank"]),
          "PageRank resumed from round 5 differs")
    mr, mr_s = wall_s(lambda: comp.run(InDegree(), {},
                                       map_reduces=[DegreeHistogram()]))
    launches = S.seg_scan.launches
    # ---- end of the checkpoint path
    check(launches > 0, "the checkpoint path never launched seg_scan")
    shutil.rmtree(root, ignore_errors=True)
    deg = np.diff(snap.indptr_in)
    check(np.array_equal(mr["deg"], deg), "InDegree differs from indptr")
    values, counts = np.unique(deg, return_counts=True)
    check(mr.memory["degrees"] == dict(zip(values.tolist(),
                                           counts.tolist())),
          "the classic MapReduce degree histogram differs from numpy")
    say(f"phase 5c: s{ENGINE_SCALE} PageRank checkpointed every "
        f"{CKPT_EVERY} on {card}: {full_s:.4f} s (rounds 5, 10, 15, 20), "
        f"bit-equal to the run without checkpoints; rounds 15 and 20 "
        f"removed, resumed from 10 in {res1_s:.4f} s, bit-equal; round 10 "
        f"corrupted, latest() fell back to 5, resumed bit-equal; classic "
        f"MapReduce (in-degree histogram, {len(values)} degrees over "
        f"{snap.n} vertex views) equal to numpy in {mr_s:.1f} s; seg_scan "
        f"launches {launches}")
    return launches


def validate(g, dist, source: int, inf: int) -> None:
    """Graph500's BFS validation rules, on the card, over every stored
    (symmetric) edge: dist[source] == 0; every edge joins two reached or
    two unreached vertices, with |dist[u] - dist[v]| <= 1; every reached
    vertex other than the source has a neighbour one level closer."""
    n, dstT, degc = g["n"], g["dstT"], g["degc"]
    check(int(dist[source]) == 0, "dist[source] != 0")
    q = g["q_total"] - 1
    owner = torch.repeat_interleave(
        torch.arange(n, device=dist.device, dtype=torch.int32),
        degc[:n].long(), output_size=q)
    has_parent = torch.zeros(n + 1, dtype=torch.bool, device=dist.device)
    bad = torch.zeros((), dtype=torch.int64, device=dist.device)
    step = 1 << 25
    for c0 in range(0, q, step):
        c1 = min(c0 + step, q)                 # the sink column owns nothing
        u = owner[c0:c1].long()
        du = dist[u]
        for lane in range(8):
            v = dstT[lane, c0:c1]
            real = v < n
            dv = dist[v.clamp(max=n - 1).long()]
            ru, rv = du < inf, dv < inf
            bad += (real & ((ru != rv) | (ru & ((du - dv).abs() > 1)))).sum()
            up = real & ru & (dv == du - 1)
            has_parent[torch.where(up, u, n)] = True
    orphan = (dist < inf) & ~has_parent[:n]
    orphan[source] = False
    check(int(bad) == 0, f"{int(bad)} edges break the level rules")
    check(int(orphan.sum()) == 0,
          f"{int(orphan.sum())} reached vertices have no parent")


def sector_bytes(offsets, itemsize: int) -> int:
    """Bytes in the distinct 32-byte sectors that hold the elements at
    int64 ``offsets`` of an array of ``itemsize``-byte elements."""
    return 32 * torch.unique((offsets * itemsize) >> 5).numel()


def word_byte(par, Kp: int, plane: int):
    """The byte offset of the parents' words in a plane of ``plane``
    bytes, clamped as the kernels clamp them (int64)."""
    par = par.long()
    if Kp >= 8:
        return par.clamp(0, plane * 8 // Kp - 1) * (Kp // 8)
    return ((par * Kp) >> 3).clamp(0, plane - 1)


def word_value(plane, wbyte, par, Kp: int):
    """The int64 words of the parents ``par`` at their byte offsets
    ``wbyte`` (``word_byte``) in one plane (uint8)."""
    if Kp >= 8:
        return sum(plane[wbyte + i].long() << (8 * i) for i in range(Kp // 8))
    return (plane[wbyte].long() >> ((par.long() * Kp) & 7)) & ((1 << Kp) - 1)


def round_bytes(a, lanes: int) -> dict:
    """The bytes one round must move for these inputs, each input read
    once and each output written once. A read that depends on the data
    counts the 32-byte sectors this call's data needs: ``cols`` and the
    dstT lanes of candidates some job still wants; the frontier sectors
    of the parents tested; ``has_more`` for the candidates that missed in
    every lane; ``pay0``/``pay1`` for the survivors. ``undec`` is read
    whole, and ``found`` and the two compacted lists are written whole.
    The dstT sectors are counted under two layouts of the same lanes:
    ``[8, Q]``, the port's, where the leading ``lanes`` rows are read for
    the wanted candidates and the other rows for those some job missed
    in them (``dstT_8q``), and ``[Q, 8]``, where one column's 8 lanes
    share one sector (``dstT_q8``: 32 B a distinct wanted column). The
    frontier sectors are counted under two layouts of the same bits:
    job-major ``[K, nb]`` bitmaps, one sector a (parent, job) tested
    (``fbits_rows``), and the vertex-major words, one sector a (parent,
    group of 32 jobs) tested (``fbits_words``). ``bytes`` takes the
    smaller of each pair: the least the card could move for this work;
    ``bytes_8q``/``bytes_q8`` fix the dstT layout and ``bytes_rows``/
    ``bytes_words`` the frontier's. Also returns the wanted candidates
    (``live``) and the survivor count this model finds, which must equal
    the kernel's ``nsur``."""
    dstT, tb, undec, fb = a["dstT"], a["tbits"], a["undec"], a["fbits"]
    K, C = undec.shape
    Kp, G = word_bits(K)
    # the bits as given: words, or a parent checkout's job-major rows
    job_major = K > 1 and fb.shape[0] == K
    if job_major:
        nb, plane = fb.shape[1], fb.shape[1] * Kp
    else:
        plane = fb.shape[1]
        nb = -(-(plane * 8 // Kp) // 8)
    Q = dstT.shape[1]
    dev = dstT.device
    col = a["cols"].long().clamp(0, Q - 1)
    j = torch.arange(C, device=dev)
    live = undec.any(0)
    open_ = None
    if tb is not None:
        lane = torch.arange(8, device=dev)[:, None]
        w = tb[col.clamp(max=tb.numel() - 1)].int()   # slot col*8+l: byte col
        open_ = ((w[None] >> lane) & 1) == 0
    # the 32-byte sectors that the tests touch, marked job by job (rows)
    # and group by group (words): no [K, lanes, C] temporary (34 GB at
    # K = 16, C = 2^26)
    touched = torch.zeros(((K * nb - 1) >> 5) + 1, dtype=torch.bool,
                          device=dev)
    wtouched = torch.zeros(((G * plane - 1) >> 5) + 1, dtype=torch.bool,
                           device=dev)

    def test(l0, l1, want):
        """Hits of lanes [l0, l1) for the [K, C] candidates in ``want``,
        each parent clamped by the rule of the layout given."""
        par = dstT[l0:l1][:, col]
        byte = (par >> 3).long().clamp(0, nb - 1)
        shift = (par & 7).to(torch.uint8)
        wbyte = word_byte(par, Kp, plane)
        words = []
        for g in range(G):
            tested = want[32 * g:32 * g + 32].any(0)[None, :].expand_as(par)
            if open_ is not None:
                tested = tested & open_[l0:l1]
            wtouched[(g * plane + wbyte[tested]) >> 5] = True
            if not job_major:
                words.append(word_value(fb[g], wbyte, par, Kp))
        del wbyte
        hit = torch.empty((K, C), dtype=torch.bool, device=dev)
        for k in range(K):
            tested = want[k][None, :].expand_as(par)
            if open_ is not None:
                tested = tested & open_[l0:l1]
            touched[(k * nb + byte[tested]) >> 5] = True
            bit = ((fb[k][byte] >> shift) & 1 if job_major
                   else (words[k >> 5] >> (k & 31)) & 1) > 0
            torch.any(tested & bit, dim=0, out=hit[k])
        return hit

    hit = test(0, lanes, undec)
    missed = undec & ~hit
    del hit
    wide = missed.any(0) if lanes < 8 else torch.zeros_like(live)
    if lanes < 8:
        missed = missed & ~test(lanes, 8, missed)
    out_miss = missed.any(0)
    del missed
    surv = out_miss & a["has_more"]
    dstT_8q = sum(sector_bytes(l * Q + col[live if l < lanes else wide], 4)
                  for l in range(8))
    dstT_q8 = sector_bytes(col[live], 32)
    fbits_rows = 32 * int(touched.sum())
    fbits_words = 32 * int(wtouched.sum())
    rest = (sector_bytes(j[live], 4) + K * C
            + (0 if tb is None else sector_bytes(col[live], 1))
            + sector_bytes(j[out_miss], 1) + 2 * sector_bytes(j[surv], 4)
            + K * C + 8 * C + 4)
    d_min, f_min = min(dstT_8q, dstT_q8), min(fbits_rows, fbits_words)
    return {"bytes": rest + d_min + f_min,
            "bytes_8q": rest + dstT_8q + f_min,
            "bytes_q8": rest + dstT_q8 + f_min,
            "bytes_rows": rest + d_min + fbits_rows,
            "bytes_words": rest + d_min + fbits_words,
            "dstT_8q": dstT_8q, "dstT_q8": dstT_q8,
            "fbits_rows": fbits_rows, "fbits_words": fbits_words,
            "live": int(live.sum()), "nsur": int(surv.sum())}


EXHAUST_ARGS = ("cols", "owner", "p_total", "fbits", "tbits", "dstT")


def exhaust_call(fn, e):
    """``fn`` (the sweep's wrapper, plain version or kernel launch) on the
    inputs ``e``."""
    return fn(*(e[k] for k in EXHAUST_ARGS), K=e["K"], c_cap=e["c_cap"])


def exhaust_bytes(e) -> dict:
    """The bytes one sweep must move for these inputs, each input read
    once and each output written once, in the 32-byte sectors this call's
    data needs: ``cols`` and ``owner`` of the live pairs (j < p_total, a
    contiguous run); the dstT sectors of their open slots, under
    ``[8, Q]`` (the port's) and under ``[Q, 8]`` (32 B a distinct column
    with an open slot), the smaller counting; the ``tbits`` sector of
    each live column; the word sectors of their open parents, plane by
    plane; ``p_total``; the ``[G, c_cap]`` words written once. Marked in
    slices of 2^24 pairs on bool arrays, not listed."""
    K, c_cap = e["K"], e["c_cap"]
    Kp, G = word_bits(K)
    dstT, fb, tb = e["dstT"], e["fbits"], e["tbits"]
    Q, plane, dev = dstT.shape[1], fb.shape[1], dstT.device
    live = min(max(int(e["p_total"]), 0), e["cols"].numel())
    d8q = torch.zeros(((8 * Q * 4 - 1) >> 5) + 1, dtype=torch.bool,
                      device=dev)
    dq8 = torch.zeros(Q, dtype=torch.bool, device=dev)
    tsec = torch.zeros((((tb.numel() if tb is not None else 1) - 1) >> 5)
                       + 1, dtype=torch.bool, device=dev)
    wsec = torch.zeros(((G * plane - 1) >> 5) + 1, dtype=torch.bool,
                       device=dev)
    lane = torch.arange(8, device=dev)[:, None]
    step = 1 << 24
    for s0 in range(0, live, step):
        col = e["cols"][s0:min(s0 + step, live)].long().clamp(0, Q - 1)
        if tb is None:
            open_ = torch.ones((8, col.numel()), dtype=torch.bool,
                               device=dev)
        else:
            tcol = col.clamp(max=tb.numel() - 1)
            tsec[tcol >> 5] = True
            open_ = ((tb[tcol][None].int() >> lane) & 1) == 0
        d8q[((lane * Q + col[None]) * 4 >> 5)[open_]] = True
        dq8[col[open_.any(0)]] = True
        wb = word_byte(dstT[:, col], Kp, plane)[open_]
        for g in range(G):
            wsec[(g * plane + wb) >> 5] = True
        del open_, wb
    pairs = 2 * 32 * (-(-live * 4 // 32))
    dstT_8q, dstT_q8 = 32 * int(d8q.sum()), 32 * int(dq8.sum())
    words = 32 * int(wsec.sum())
    rest = (pairs + (32 * int(tsec.sum()) if tb is not None else 0) + 4
            + words + G * c_cap * 4)
    return {"bytes": rest + min(dstT_8q, dstT_q8), "dstT_8q": dstT_8q,
            "dstT_q8": dstT_q8, "words": words, "live": live}


def exhaust_replay(F, e) -> dict:
    """One sweep replayed: the kernel's words and the wrapper's found_per
    against the plain version (bit-equal), the kernel's time (its launch
    and the zeroed words: ``ms``), the wrapper's (with the expansion to
    [K, c_cap] bool: ``wrapper_ms``) and the plain version's, each the
    mean of several after a warm-up, and the bound (``exhaust_bytes``)."""
    got = exhaust_call(F.batched_exhaust, e)
    ref = exhaust_call(F.batched_exhaust_reference, e)
    check(torch.equal(got, ref), "batched_exhaust differs from its plain "
          f"version (K={e['K']}, P={e['cols'].numel()})")
    ms = cuda_ms(lambda: exhaust_call(F._launch_exhaust, e), 10, warmup=2)
    wrapper_ms = cuda_ms(lambda: exhaust_call(F.batched_exhaust, e), 10)
    plain_ms = cuda_ms(lambda: exhaust_call(F.batched_exhaust_reference, e),
                       2)
    work = exhaust_bytes(e)
    return {"K": e["K"], "P": e["cols"].numel(), "c_cap": e["c_cap"],
            "found": int(got.sum()), "max_abs_err": 0, "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": work["bytes"] / HBM_BYTES_PER_S * 1e3, **work}


ROUND_ARGS = ("cols", "undec", "has_more", "pay0", "pay1", "fbits", "tbits",
              "dstT")


def trace_calls(P, g, src: int):
    """One BFS from ``src`` with CUDA events around every
    ``frontier_round`` call. Returns ``(calls, levels, seconds)``: each
    call a dict of its inputs ``a``, ``kw``, ``C`` and device
    ``ms``; the inputs are kept for replays."""
    real = P.frontier_round
    calls = []

    def traced(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*args, **kw)
        e1.record()
        calls.append({"a": dict(zip(ROUND_ARGS, args)), "kw": kw,
                      "C": args[0].shape[0], "events": (e0, e1)})
        return out

    P.frontier_round = traced
    try:
        torch.cuda.synchronize()
        t = time.time()
        _, levels = P.frontier_bfs_hybrid(g, src, return_device=True)
        torch.cuda.synchronize()
        seconds = time.time() - t
    finally:
        P.frontier_round = real
    for c in calls:
        e0, e1 = c.pop("events")
        c["ms"] = e0.elapsed_time(e1)
    return calls, levels, seconds


def replay(F, c) -> dict:
    """Replays one main-path call: bit-equality with the plain version,
    the kernel's time (mean of 10 after 2 warm-ups) and the plain
    version's, and the bytes and bound under both dstT layouts."""
    a, kw = c["a"], c["kw"]
    args = [a[k] for k in ROUND_ARGS]
    got = F.frontier_round(*args, **kw)
    ref = F.frontier_round_reference(*args, **kw)
    err = max_abs_err(got, ref)
    check(err == 0, "frontier_round differs from its plain version at a "
          "main-path call")
    ms = cuda_ms(lambda: F.frontier_round(*args, **kw), 10, warmup=2)
    plain_ms = cuda_ms(lambda: F.frontier_round_reference(*args, **kw), 3)
    work = round_bytes(a, kw["lanes"])
    check(work["nsur"] == int(got[3]), "the byte model's survivor count "
          "differs from the kernel's")

    def bound(b):
        return b / HBM_BYTES_PER_S * 1e3
    return {"source": c["source"], "call": c["index"], "C": c["C"],
            "K": a["undec"].shape[0], "nsur": int(got[3]),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound(work["bytes"]),
            "bound_ms_8q": bound(work["bytes_8q"]),
            "bound_ms_q8": bound(work["bytes_q8"]),
            "bound_ms_rows": bound(work["bytes_rows"]),
            "bound_ms_words": bound(work["bytes_words"]), **work}


def trace_sources(P, g, srcs):
    """One traced BFS per source (``trace_calls``); returns the widest
    call (the first of the largest C), the call whose bound bytes
    (``round_bytes``) are largest, each tagged with its source and
    index, and the number of calls per source. Only those two calls'
    inputs are kept."""
    widest = heaviest = None
    per_source = []
    for src in srcs:
        calls, levels, seconds = trace_calls(P, g, src)
        for i, c in enumerate(calls):
            c.update(source=src, index=i,
                     **round_bytes(c["a"], c["kw"]["lanes"]))
            if widest is None or c["C"] > widest["C"]:
                widest = c
            if heaviest is None or c["bytes"] > heaviest["bytes"]:
                heaviest = c
        per_source.append(len(calls))
        say(f"traced BFS from {src}: {levels} levels in {seconds:.4f} s, "
            f"frontier_round {len(calls)} calls, "
            f"{sum(c['ms'] for c in calls):.4f} ms summed (CUDA events "
            f"around each call); each call's C, wanted candidates, ms, "
            f"dstT sector bytes under [8, Q] and [Q, 8], bound bytes: "
            + "; ".join(f"{c['C']} {c['live']} {c['ms']:.4f} {c['dstT_8q']} "
                        f"{c['dstT_q8']} {c['bytes']}" for c in calls))
        del calls
    return widest, heaviest, per_source


def say_replay(name: str, r: dict) -> None:
    say(f"{name} frontier_round call (source {r['source']}, call "
        f"{r['call']}) C={r['C']} K={r['K']} nsur={r['nsur']}: bit-equal to "
        f"the plain version (max_abs_err {r['max_abs_err']}, tolerance 0); "
        f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; bytes "
        f"under [8, Q] {r['bytes_8q']} (dstT {r['dstT_8q']}), under [Q, 8] "
        f"{r['bytes_q8']} (dstT {r['dstT_q8']}); frontier sectors "
        f"{r['fbits_rows']} B job-major, {r['fbits_words']} B as words; "
        f"bound {r['bound_ms']:.4f} ms (the smaller counts at 3.35 TB/s; "
        f"dstT [8, Q] {r['bound_ms_8q']:.4f}, [Q, 8] {r['bound_ms_q8']:.4f}; "
        f"frontier job-major {r['bound_ms_rows']:.4f}, words "
        f"{r['bound_ms_words']:.4f} ms), {100 * r['bound_ms'] / r['ms']:.1f}% "
        f"of it; the survivor count of the byte model equals nsur")


#: the jobs the widest cohort call is cut to: the frontier bits of 4 jobs
#: fit the 50 MB L2 at s26 in either layout, those of 16 do not
SWEEP_K = (4, 8, 16)


def k_sweep(F, widest, card) -> list[dict]:
    """The widest cohort call replayed with its first k jobs, k in
    ``SWEEP_K`` (``first_jobs``): time, time a job, bound, and the
    frontier sectors under both layouts."""
    out = []
    for k in SWEEP_K:
        r = replay(F, {**widest, "a": first_jobs(widest["a"], k)})
        out.append({"K": k, "ms": r["ms"], "ms_per_job": r["ms"] / k,
                    **{x: r[x] for x in (
                        "plain_ms", "bound_ms", "bound_ms_rows",
                        "bound_ms_words", "fbits_rows", "fbits_words",
                        "nsur")}})
        say(f"K sweep on {card}: the widest cohort call (C={r['C']}) cut "
            f"to its first {k} jobs: kernel {r['ms']:.4f} ms, "
            f"{r['ms'] / k:.4f} ms a job; bit-equal to the plain version "
            f"({r['plain_ms']:.4f} ms); frontier sectors {r['fbits_rows']} B "
            f"job-major, {r['fbits_words']} B as words; bound "
            f"{r['bound_ms']:.4f} ms (job-major {r['bound_ms_rows']:.4f}, "
            f"words {r['bound_ms_words']:.4f})")
        torch.cuda.empty_cache()
    return out


def phase_main(F, P, G, host_build, card) -> tuple:
    from titan_tpu_torch.device import INF

    hg, build_s = host_build.result()
    t0 = time.time()
    g = G.graph_from_numpy(hg, "cuda")
    torch.cuda.synchronize()
    upload_s = time.time() - t0
    say(f"phase 6: s{SCALE} host build {build_s:.1f} s (native, "
        f"{hg['n']} vertices, {hg['e_sym']} symmetrized input edges, "
        f"q_total {hg['q_total']}), upload {upload_s:.1f} s, dstT "
        f"{g['dstT'].numel() * 4 / 1e9:.2f} GB")
    srcs = sample_sources(hg["deg"], NUM_SOURCES)
    deg_orig = np.asarray(hg["deg_orig"])
    deg_dev = G.device_degrees(deg_orig, "cuda")

    # ---- the main path, with the kernel counts from 0
    F.frontier_round.launches = 0
    runs = 0

    def bfs(src):
        nonlocal runs
        torch.cuda.synchronize()
        t = time.time()
        dist, levels = P.frontier_bfs_hybrid(g, src, return_device=True)
        torch.cuda.synchronize()
        runs += 1
        return dist, levels, time.time() - t

    bfs(srcs[0])                                   # warm-up
    warm = F.frontier_round.launches
    # one traced run a source: CUDA events around every frontier_round
    # call, and the widest and the heaviest call kept for the replays
    widest, heaviest, per_call = trace_sources(P, g, srcs)
    runs += len(srcs)

    per_source = []
    for src in srcs:
        best = None
        for _ in range(REPS):
            dist, levels, t = bfs(src)
            if best is None or t < best[2]:
                best = (dist, levels, t)
        dist, levels, t_bfs = best
        m2, nreach = G.reachable_edge_sum(dist, deg_orig, INF,
                                          deg_dev=deg_dev)
        per_source.append({"source": src, "dist": dist, "levels": levels,
                           "t_bfs": t_bfs, "reach": nreach,
                           "m_traversed": m2 // 2,
                           "teps": (m2 // 2) / t_bfs})
    launches = F.frontier_round.launches
    # ---- end of the main path
    check(launches > 0, "the main path never launched frontier_round")
    check(launches == warm + (1 + REPS) * sum(per_call),
          "a source's BFS runs launched frontier_round unequal times")

    for r in per_source:
        validate(g, r.pop("dist"), r["source"], INF)
    teps = len(per_source) / sum(1.0 / r["teps"] for r in per_source)
    say(f"phase 6: Graph500 s{SCALE} ef{EDGE_FACTOR} on {card}: "
        f"TEPS {teps:.6g} (harmonic mean over {len(per_source)} "
        f"sources, best of {REPS}); per source "
        + json.dumps(per_source))
    say(f"phase 6: Graph500 validation passed for every source; "
        f"frontier_round launches {launches} over {runs} BFS runs "
        f"({per_call} a run, by source)")
    recs = {"widest": replay(F, widest)}
    recs["heaviest"] = (recs["widest"] if heaviest is widest
                        else replay(F, heaviest))
    for name, r in recs.items():
        say_replay(name, r)
    w = recs["widest"]
    return g, hg, {**KERNEL, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
            "ms": w["ms"], "plain_ms": w["plain_ms"],
            "bound_ms": w["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "replays": [{"replay": name, **{k: r[k] for k in (
                "source", "call", "C", "nsur", "ms", "plain_ms", "bound_ms",
                "bound_ms_8q", "bound_ms_q8", "bytes_8q", "bytes_q8",
                "dstT_8q", "dstT_q8")}} for name, r in recs.items()]}


#: the batched BFS cohort and the interactive lane's hops batch: the
#: serving batcher's and the interactive scheduler's max_batch
BATCH_K = 16
#: the interactive shape V(x).out().out()
HOPS_DEPTH = 2
#: the share of edge slots the seeded tbits of the K = 16 replay mask
TOMB_SHARE = 0.01
#: exhaust pairs a slice of the plain sweep at s16, so the CPU folds many
#: slices there (the kernel does not slice); at s26 the module's own
SMALL_EXHAUST_SLICE = 1 << 12


class BatchedTrace:
    """CUDA events around the batched BFS's level steps (plan, rounds,
    exhaust, overlay scatter), every frontier_round call and every
    batched_exhaust call of one run. Keeps the inputs of the widest round
    (the first of the largest C) and of the largest sweep (the first of
    the most listed pairs) for the replays, the largest exhaust p_cap and
    each level's split. (A checkout from before the sweep kernel has no
    ``batched_exhaust`` to trace; the rest is traced the same.)"""

    #: each step, the position of its ``level`` argument and its column
    STEPS = {"_batched_plan": (2, "plan"), "_batched_rounds": (5, "rounds"),
             "_batched_exhaust": (5, "exhaust"),
             "_overlay_scatter_batched": (4, "overlay")}

    def __init__(self, P):
        self.P, self.events, self.calls, self.sweeps = P, [], [], []
        self.widest, self.largest, self.p_cap = None, None, 0

    def __enter__(self):
        P = self.P
        self.real = {k: getattr(P, k) for k in (
            *self.STEPS, "frontier_round", "batched_exhaust")
            if hasattr(P, k)}

        def wrap(name, fn, at, col):
            def traced(*a, **kw):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                self.events.append((col, int(a[at]), e0, e1))
                if col == "exhaust":
                    self.p_cap = max(self.p_cap, int(a[8]))
                return out
            return traced

        def round_(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.real["frontier_round"](*a, **kw)
            e1.record()
            C = a[0].shape[0]
            self.calls.append((C, a[1].shape[0], e0, e1))
            if self.widest is None or C > self.widest["C"]:
                self.widest = {"a": dict(zip(ROUND_ARGS, a)), "kw": kw,
                               "C": C, "index": len(self.calls) - 1}
            return out
        def sweep(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.real["batched_exhaust"](*a, **kw)
            e1.record()
            n = a[0].shape[0]
            self.sweeps.append((n, e0, e1))
            if self.largest is None or n > self.largest["P"]:
                self.largest = {**dict(zip(EXHAUST_ARGS, a)), **kw, "P": n,
                                "index": len(self.sweeps) - 1}
            return out
        for k, (at, col) in self.STEPS.items():
            setattr(P, k, wrap(k, self.real[k], at, col))
        P.frontier_round = round_
        if "batched_exhaust" in self.real:
            P.batched_exhaust = sweep
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.P, k, fn)
        torch.cuda.synchronize()
        return False

    def split(self) -> list[dict]:
        """Per level: device ms of plan, rounds, exhaust, overlay."""
        rows = {}
        for col, level, e0, e1 in self.events:
            r = rows.setdefault(level, {"level": level, "plan": 0.0,
                                        "rounds": 0.0, "exhaust": 0.0,
                                        "overlay": 0.0})
            r[col] += e0.elapsed_time(e1)
        return [rows[k] for k in sorted(rows)]

    def kernel_ms(self) -> float:
        return sum(e0.elapsed_time(e1) for _, _, e0, e1 in self.calls)

    def sweep_ms(self) -> list[float]:
        """Device ms of each batched_exhaust call, in order."""
        return [e0.elapsed_time(e1) for _, e0, e1 in self.sweeps]


def expand_once(g, mask):
    """The top-down neighbour set of the vertices in ``mask`` (bool [n]),
    in plain torch from dstT: each vertex's columns, all 8 lanes, pads
    dropped; in slices of 2^24 columns."""
    n, dstT = g["n"], g["dstT"]
    v = torch.nonzero(mask).flatten()
    cnt = g["degc"][v].long()
    first = g["colstart"][v].long()
    ends = torch.cumsum(cnt, 0)
    total = int(ends[-1]) if v.numel() else 0
    out = torch.zeros(n + 2, dtype=torch.bool, device=dstT.device)
    step = 1 << 24
    for c0 in range(0, total, step):
        j = torch.arange(c0, min(c0 + step, total), device=dstT.device)
        owner = torch.searchsorted(ends, j, right=True)
        cols = first[owner] + (j - (ends[owner] - cnt[owner]))
        out[dstT[:, cols].flatten().long()] = True
    return out[:n]


def hop_encoding(g, x: int, depth: int, start_level: int):
    """What a hops run of ``depth`` sweeps from ``x`` leaves in its dist
    row: the last hop h a vertex is in, stamped h + start_level, 0 where
    none; from ``expand_once`` alone."""
    cur = torch.zeros(g["n"], dtype=torch.bool, device=g["dstT"].device)
    cur[x] = True
    enc = torch.where(cur, start_level, 0).to(torch.int32)
    sizes = []
    for h in range(1, depth + 1):
        cur = expand_once(g, cur)
        enc[cur] = h + start_level
        sizes.append(int(cur.sum()))
    return enc, sizes


def phase_batched(F, P, G, g, hg, card) -> tuple[list, dict, list, dict]:
    """Phase 7 at s26 on phase 6's graph: the K = 16 BFS cohort against
    16 single-source runs, the interactive hops batch against a top-down
    expansion, the widest K = 16 frontier_round call replayed with and
    without tbits and cut to 4, 8 and 16 jobs, and the largest cohort
    sweep replayed. Returns frontier_round's replays, its launches by
    path and the K sweep, and batched_exhaust's record."""
    from titan_tpu_torch.device import INF

    n = g["n"]
    srcs = sample_sources(hg["deg"], BATCH_K)
    deg_orig = np.asarray(hg["deg_orig"])
    deg_dev = G.device_degrees(deg_orig, "cuda")

    # the references: single-source BFS from each source, best of REPS
    singles = []
    for src in srcs:
        best = None
        for _ in range(REPS):
            (dist, levels), t = wall_s(lambda: P.frontier_bfs_hybrid(
                g, src, return_device=True))
            if best is None or t < best[2]:
                best = (dist, levels, t)
        singles.append(best)
    t_singles = sum(b[2] for b in singles)
    edges = [G.reachable_edge_sum(b[0], deg_orig, INF, deg_dev=deg_dev)[0]
             // 2 for b in singles]

    # ---- the main path (the serving batcher's BFS cohort), counts from 0
    F.frontier_round.launches = 0
    F.batched_exhaust.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()

    def cohort():
        return P.frontier_bfs_batched(g, srcs, return_device=True)
    cohort()                                             # warm-up
    runs = []
    for _ in range(REPS):
        runs.append(wall_s(cohort))
    (dist, levels, completed), t_batch = min(runs, key=lambda r: r[1])
    with BatchedTrace(P) as tr:
        _, t_traced = wall_s(cohort)
    launches = F.frontier_round.launches
    x_launches = F.batched_exhaust.launches
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    per_run = len(tr.calls)
    check(per_run > 0 and launches == (2 + REPS) * per_run,
          f"the cohort launched frontier_round {launches} times over "
          f"{2 + REPS} runs of {per_run} calls")
    check(tr.sweeps and x_launches == (2 + REPS) * len(tr.sweeps),
          f"the cohort launched batched_exhaust {x_launches} times over "
          f"{2 + REPS} runs of {len(tr.sweeps)} calls")
    check(all(k == BATCH_K for _, k, _, _ in tr.calls),
          "a cohort round ran with another K")
    check(bool(completed.all()), "a cohort job did not complete")
    for k, (d1, lv1, _) in enumerate(singles):
        check(torch.equal(dist[k], d1), f"cohort row {k} (source "
              f"{srcs[k]}) differs from frontier_bfs_hybrid")
        check(int(levels[k]) == lv1, f"cohort row {k}: {levels[k]} "
              f"levels, frontier_bfs_hybrid {lv1}")
    del runs, singles
    m_batch = sum(edges)
    say(f"phase 7: K={BATCH_K} cohort at s{SCALE} on {card}: all 16 rows "
        f"bit-equal to frontier_bfs_hybrid from the same sources, levels "
        f"equal, every job completed; batched wall {t_batch:.4f} s (best "
        f"of {REPS} after a warm-up; traced run {t_traced:.4f} s) against "
        f"{t_singles:.4f} s summed over the 16 single-source best-of-"
        f"{REPS} times; {m_batch} traversed input edges summed over the "
        f"jobs (Graph500's count), {m_batch / t_batch:.6g} edges/s over "
        f"the batched wall ({sum(edges) / t_singles:.6g} over the summed "
        f"single-source times); frontier_round {launches} launches over "
        f"{2 + REPS} runs ({per_run} a run, K={BATCH_K}), "
        f"{tr.kernel_ms():.4f} ms summed in the traced run; "
        f"batched_exhaust {x_launches} launches ({len(tr.sweeps)} a run), "
        f"{', '.join(f'{x:.4f}' for x in tr.sweep_ms())} ms each in the "
        f"traced run; largest exhaust p_cap {tr.p_cap}; peak memory "
        f"{peak / 2**30:.3f} GiB ({(peak - base_mem) / 2**30:.3f} GiB "
        f"above the graph and the 16 reference rows)")
    say(f"phase 7: cohort per-level split on {card} (device ms by CUDA "
        f"events, traced run): " + json.dumps(
            [{k: (round(v, 4) if isinstance(v, float) else v)
              for k, v in r.items()} for r in tr.split()]))
    widest = {**tr.widest, "source": "cohort"}
    largest = tr.largest
    del tr, dist

    # ---- the interactive lane's hops batch, counts from 0
    depths = [HOPS_DEPTH] * BATCH_K

    def on_level(level, nf):
        keep = np.asarray([level <= d for d in depths])
        return keep if not keep.all() else None

    def hops():
        return P.frontier_bfs_batched(
            g, srcs, max_levels=HOPS_DEPTH + 1, start_level=1,
            on_level=on_level, mode="hops", return_device=True)
    F.frontier_round.launches = 0
    F.batched_exhaust.launches = 0
    hops()
    h_runs = [wall_s(hops) for _ in range(REPS)]
    h_launches = F.frontier_round.launches
    h_x_launches = F.batched_exhaust.launches
    # ---- end of the hops path
    (hd, _, _), t_hops = min(h_runs, key=lambda r: r[1])
    check(h_launches > 0, "the hops batch never launched frontier_round")
    sizes = []
    for k, x in enumerate(srcs):
        enc, sz = hop_encoding(g, x, HOPS_DEPTH, 1)
        check(torch.equal(hd[k], enc), f"hops row {k} (start {x}) differs "
              f"from the top-down expansion")
        sizes.append(sz)
    del h_runs, hd
    say(f"phase 7: hops batch K={BATCH_K}, depth {HOPS_DEPTH}, start_level "
        f"1 at s{SCALE} on {card}: every row equals a top-down expansion "
        f"from dstT in plain torch (dist == 3 is hop 2, dist == 2 hop 1 "
        f"minus hop 2, dist == 1 the start if in neither); hop-1 and hop-2 "
        f"sizes {sizes}; {t_hops:.4f} s (best of {REPS}), frontier_round "
        f"{h_launches} launches, batched_exhaust {h_x_launches}, over "
        f"{1 + REPS} runs")

    # ---- the widest K = 16 call, replayed as run and with seeded tbits
    recs = {"cohort_k16": replay(F, widest)}
    q = g["dstT"].shape[1]
    gen = torch.Generator(device="cuda").manual_seed(13)
    tb = torch.zeros(q, dtype=torch.uint8, device="cuda")
    for b in range(8):
        tb |= ((torch.rand(q, generator=gen, device="cuda") < TOMB_SHARE)
               .to(torch.uint8) << b)
    masked = {**widest, "a": {**widest["a"], "tbits": tb}}
    recs["cohort_k16_tbits"] = replay(F, masked)
    for name, r in recs.items():
        say_replay(f"{name} (K={BATCH_K}) on {card}:", r)
    del masked, tb
    sweep = k_sweep(F, widest, card)
    del widest
    torch.cuda.empty_cache()

    # ---- the largest cohort sweep, replayed
    x = exhaust_replay(F, largest)
    say(f"largest cohort batched_exhaust call (call {largest['index']}, "
        f"K={x['K']}, P={x['P']}, {x['live']} live pairs, c_cap="
        f"{x['c_cap']}, {x['found']} candidate bits found) on {card}: "
        f"bit-equal to the plain version (tolerance 0); kernel "
        f"{x['ms']:.4f} ms (the launch and its zeroed words; with the "
        f"wrapper's expansion to [K, c_cap] bool {x['wrapper_ms']:.4f} ms), "
        f"plain {x['plain_ms']:.4f} ms; bytes {x['bytes']} (dstT "
        f"[8, Q] {x['dstT_8q']}, [Q, 8] {x['dstT_q8']}; words "
        f"{x['words']}); bound {x['bound_ms']:.4f} ms at 3.35 TB/s, "
        f"{100 * x['bound_ms'] / x['ms']:.1f}% of it")
    del largest
    torch.cuda.empty_cache()
    x_rec = {**EXHAUST_KERNEL, "launches": x_launches + h_x_launches,
             "max_abs_err": 0, "ms": x["ms"], "plain_ms": x["plain_ms"],
             "bound_ms": x["bound_ms"], "bound_by": "bytes",
             "library_ms": None,
             "launches_by_path": {"bfs_batched": x_launches,
                                  "hops": h_x_launches},
             "replay": {k: x[k] for k in (
                 "K", "P", "live", "c_cap", "found", "ms", "wrapper_ms",
                 "plain_ms", "bound_ms", "bytes", "dstT_8q", "dstT_q8",
                 "words")}}
    return ([{"replay": name, "K": BATCH_K, **{k: r[k] for k in (
        "source", "call", "C", "nsur", "ms", "plain_ms", "bound_ms",
        "bound_ms_8q", "bound_ms_q8", "bound_ms_rows", "bound_ms_words",
        "bytes_8q", "bytes_q8", "bytes_rows", "bytes_words", "dstT_8q",
        "dstT_q8", "fbits_rows", "fbits_words")}}
             for name, r in recs.items()],
            {"bfs_batched": launches, "hops": h_launches}, sweep, x_rec)


def phase_batched_small(F, P, G, SN, OV, card) -> None:
    """Phase 7 at s16: the batched BFS on the card equals the port on the
    CPU under a live overlay with adds and removals, with level masks, in
    a checkpoint and a resume from it, and with a job dropped through
    on_level; every card run launches frontier_round, the overlay and
    mask runs with tbits."""
    hg = G.load_or_build(SMALL_SCALE, EDGE_FACTOR, seed=SEED, verbose=False)
    snap = SN.from_chunked_csr(hg)
    rng = np.random.default_rng(21)
    srcs = sample_sources(hg["deg"], BATCH_K)
    n = snap.n
    add_s = rng.integers(0, n, 300).astype(np.int32)
    add_d = rng.integers(0, n, 300).astype(np.int32)
    rm = rng.choice(snap.num_edges, 150, replace=False)
    graphs = {dev: P.build_chunked_csr(snap, dev) for dev in ("cuda", "cpu")}
    lm = rng.integers(0, 256, graphs["cpu"]["q_total"]).astype(np.uint8)
    lm[-1] = 0                                   # the all-pad sink column

    def views(dev):
        ov = OV.DeltaOverlay(snap, min_cap=1024, device=dev)
        ov.append_edges(np.concatenate([add_s, add_d]),
                        np.concatenate([add_d, add_s]),
                        np.zeros(600, np.int32))
        for i in rm:
            u, v = int(snap.src[i]), int(snap.dst[i])
            ov.remove_edge(u, v, None)
            ov.remove_edge(v, u, None)
        return ov.view()

    real_slice = F.EXHAUST_SLICE
    F.EXHAUST_SLICE = SMALL_EXHAUST_SLICE
    try:
        out, masked_calls = {}, {}
        for dev, g in graphs.items():
            lmt = torch.from_numpy(lm).to(dev)
            caps = {}

            def keep(level, dist, active):
                caps[level] = dist

            def drop(level, nf):
                return np.arange(BATCH_K) >= 4 if level >= 2 else None
            calls, sweeps = [], []
            real, real_x = P.frontier_round, P.batched_exhaust

            def spy(*a, **kw):
                calls.append(a[6] is not None)
                return real(*a, **kw)

            def spy_x(*a, **kw):
                sweeps.append(a[4] is not None)
                return real_x(*a, **kw)
            P.frontier_round, P.batched_exhaust = spy, spy_x
            try:
                runs = {
                    "overlay": P.frontier_bfs_batched(
                        g, srcs, overlay=views(dev), device=dev),
                    "level_masks": P.frontier_bfs_batched(
                        g, srcs, mode="hops", start_level=1, max_levels=4,
                        level_masks=[None, lmt, lmt], device=dev),
                    "full": P.frontier_bfs_batched(g, srcs, device=dev,
                                                   checkpoint=keep)}
                runs["resume"] = P.frontier_bfs_batched(
                    g, srcs, init_dist=caps[2][:, :n], start_level=2,
                    device=dev)
                runs["drop"] = P.frontier_bfs_batched(g, srcs,
                                                      on_level=drop,
                                                      device=dev)
            finally:
                P.frontier_round, P.batched_exhaust = real, real_x
            out[dev] = runs
            masked_calls[dev] = (len(calls), sum(calls), len(sweeps),
                                 sum(sweeps))
    finally:
        F.EXHAUST_SLICE = real_slice
    for name in out["cpu"]:
        a, b = out["cuda"][name], out["cpu"][name]
        check(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
              and np.array_equal(a[2], b[2]),
              f"s{SMALL_SCALE} batched {name}: the card differs from the CPU")
    check(np.array_equal(out["cuda"]["resume"][0], out["cuda"]["full"][0]),
          "the resumed run differs from the uninterrupted one")
    total, masked, x_total, x_masked = masked_calls["cuda"]
    check(total > 0 and masked > 0, "the s16 card runs did not launch "
          "frontier_round with tbits")
    check(x_total > 0 and x_masked > 0, "the s16 card runs did not launch "
          "batched_exhaust with tbits")
    say(f"phase 7: s{SMALL_SCALE} batched BFS (K={BATCH_K}; the CPU's plain "
        f"sweep in slices of {SMALL_EXHAUST_SLICE} pairs) on the card "
        f"equals the CPU port "
        f"under a live overlay (600 rows added, {2 * len(rm)} removed), "
        f"with level masks [None, mask, mask] in hops mode, uninterrupted "
        f"and resumed from its level-2 checkpoint (equal to each other), "
        f"and with 4 jobs dropped at level 2; frontier_round {total} calls "
        f"on the card, {masked} of them with tbits; batched_exhaust "
        f"{x_total} calls, {x_masked} of them with tbits")


def edge_windows(FR, g):
    """(c0, c1, owners int64) over the real columns of ``g`` in windows of
    2^24 columns (the sink column owns nothing)."""
    owner = FR._colowner(g)
    q, step = g["q_total"] - 1, 1 << 24
    for c0 in range(0, q, step):
        c1 = min(c0 + step, q)
        yield c0, c1, owner[c0:c1].long()


def check_sssp(FR, g, dist, source: int) -> int:
    """SSSP checked by its edges, on ``dist``'s device, in column
    windows: dist[source] == 0; every stored edge (u, v) of weight w (the
    hash of its slot) with u reached has dist[v] <= fl(dist[u] + w) (no
    edge can still lower a distance) and joins two reached or two
    unreached vertices; every reached vertex but the source has a tight
    in-edge (dist[v] == fl(dist[u] + w)); the unreached hold FINF.
    Returns the number of reached vertices."""
    n, dstT = g["n"], g["dstT"]
    finf = float(FR.FINF)
    check(float(dist[source]) == 0.0, "dist[source] != 0")
    tight = torch.zeros(n + 1, dtype=torch.bool, device=dist.device)
    bad = torch.zeros((), dtype=torch.int64, device=dist.device)
    for c0, c1, u in edge_windows(FR, g):
        du = dist[u]
        ru = du < finf
        cols = torch.arange(c0, c1, dtype=torch.int64, device=dist.device)
        for lane in range(8):
            v = dstT[lane, c0:c1]
            real = v < n
            vl = v.clamp(max=n - 1).long()
            dv = dist[vl]
            m = du + FR._hash_weight_expr(cols * 8 + lane, 0.0, 1.0)
            bad += (real & ((ru != (dv < finf)) | (ru & (dv > m)))).sum()
            tight[torch.where(real & ru & (dv == m), vl, n)] = True
    reached = dist < finf
    orphan = reached & ~tight[:n]
    orphan[source] = False
    check(int(bad) == 0, f"{int(bad)} edges could still lower a distance "
          f"or join a reached and an unreached vertex")
    check(int(orphan.sum()) == 0,
          f"{int(orphan.sum())} reached vertices have no tight in-edge")
    check(bool((dist[~reached] == finf).all()), "an unreached vertex does "
          "not hold FINF")
    return int(reached.sum())


def check_wcc(FR, g, label) -> int:
    """WCC checked on ``label``'s device: both ends of every stored edge
    share a label (so each component carries one), no label exceeds its
    vertex, and each label labels itself. Two components sharing one
    label would pass: phase 8 compares with scipy's components, phase 9
    the giant's set with a BFS. Returns the number of labels (vertices
    that are their own label)."""
    n, dstT = g["n"], g["dstT"]
    bad = torch.zeros((), dtype=torch.int64, device=label.device)
    for _c0, _c1, u in edge_windows(FR, g):
        lu = label[u]
        for lane in range(8):
            v = dstT[lane, _c0:_c1]
            real = v < n
            bad += (real & (label[v.clamp(max=n - 1).long()] != lu)).sum()
    ids = torch.arange(n, dtype=torch.int32, device=label.device)
    check(int(bad) == 0, f"{int(bad)} edges join two labels")
    check(bool((label <= ids).all()), "a label exceeds its vertex")
    check(bool((label[label.long()] == label).all()), "a label is not its "
          "own label")
    return int((label == ids).sum())


def phase_frontier_s22(F, P, G, FR, PR, ref, card, superstep_s) -> int:
    """Phase 8 at s22 on a chunked-CSR dict from phase 5's host build:
    dense PageRank as bench.py times it, the personalized batch, SSSP,
    WCC and the SSSP cohort. Returns the WCC peel's frontier_round
    launches."""
    hg = ref["hg"]
    g = G.graph_from_numpy(hg, "cuda")
    n = g["n"]

    # ---- pagerank_dense as bench.py's pagerank_stage runs it
    FR.pagerank_dense(g, iterations=2, return_device=True)       # warm
    _, t10 = wall_s(lambda: FR.pagerank_dense(g, iterations=10,
                                              return_device=True))
    sec_it = t10 / 10
    (pr, it), t20 = wall_s(lambda: FR.pagerank_dense(g, iterations=20,
                                                     return_device=True))
    rel = float(np.max(np.abs(pr.cpu().numpy() - ref["pagerank"])
                       / ref["pagerank"]))
    check(it == 20, f"pagerank_dense ran {it} iterations")
    check(rel <= PAGERANK_RTOL, f"pagerank_dense differs from float64 by "
          f"{rel}")
    say(f"phase 8: s{ENGINE_SCALE} pagerank_dense on {card}: "
        f"{sec_it:.6f} s an iteration (bench.py's pagerank_lj_sec_per_iter "
        f"rule: the host wall of 10 iterations after a 2-iteration warm-up, "
        f"over 10; bench.py reports this one); 20 iterations in "
        f"{t20:.4f} s, within {rel:.3g} of float64 scipy (tolerance "
        f"{PAGERANK_RTOL:g}); beside it the engine's PageRank, "
        f"{superstep_s:.6f} s a superstep (phase 5, GPUGraphComputer.run "
        f"over 20)")
    del pr

    # ---- the personalized batch of the interactive lane
    users = sample_sources(hg["deg"], PPR_USERS)
    (ranks, _), t_ppr = wall_s(lambda: PR.pagerank_personalized_batched(
        g, users, iterations=20, return_device=True))
    worst, t_rows = 0.0, 0.0
    for s, v in enumerate(users):
        one = torch.zeros(n, dtype=torch.float32, device="cuda")
        one[v] = 1.0
        (row, _), t = wall_s(lambda: FR.pagerank_dense(
            g, iterations=20, reset=one, return_device=True))
        t_rows += t
        live = row > 0
        check(torch.equal(live, ranks[s] > 0), f"user {s}: the batched "
              f"row is zero elsewhere than pagerank_dense(reset=one-hot)")
        err = float(((ranks[s][live] - row[live]).abs() / row[live]).max())
        check(err <= PPR_RTOL, f"user {s} (vertex {v}): the batched row "
              f"differs from pagerank_dense(reset=one-hot) by {err}")
        worst = max(worst, err)
    top = PR.top_k_per_user(ranks, np.arange(n), k=10, exclude=users)
    for s, rows in enumerate(top):
        vals = [r for _, r in rows]
        check(len(rows) == 10 and vals == sorted(vals, reverse=True)
              and users[s] not in [v for v, _ in rows],
              f"user {s}: top-k rows are not 10 sorted others")
    say(f"phase 8: personalized PageRank, {PPR_USERS} users (bench.py's "
        f"source rule), 20 iterations: {t_ppr:.4f} s batched against "
        f"{t_rows:.4f} s for the {PPR_USERS} pagerank_dense(reset=one-hot) "
        f"runs; every row within {worst:.3g} of its run (tolerance "
        f"{PPR_RTOL:g}, relative, zeros equal); top_k_per_user: 10 sorted "
        f"rows a user, the user's own vertex excluded")
    del ranks

    # ---- SSSP and WCC from bench.py's source
    src = int(np.flatnonzero(np.asarray(hg["deg"]) > 0)[0])
    (dist, rounds), t_sssp = wall_s(lambda: FR.frontier_sssp(
        g, src, return_device=True))
    nreach = check_sssp(FR, g, dist, src)
    F.frontier_round.launches = 0
    (label, wrounds), t_wcc = wall_s(lambda: FR.frontier_wcc(
        g, return_device=True))
    peel = F.frontier_round.launches
    ncomp = check_wcc(FR, g, label)
    check(np.array_equal(label.cpu().numpy(), ref["labels"]), "WCC differs "
          "from scipy's components")
    check(torch.equal(dist < float(FR.FINF), label == label[src]),
          "SSSP's reached set is not the source's component")
    say(f"phase 8: frontier_sssp from {src} (bench.py's source): {rounds} "
        f"rounds in {t_sssp:.4f} s, {nreach} reached, every edge checked "
        f"(none can lower a distance, every reached vertex has a tight "
        f"in-edge); frontier_wcc: {wrounds} rounds (BFS peel levels "
        f"included) in {t_wcc:.4f} s, equal to scipy's components "
        f"({ncomp}), frontier_round {peel} launches in the peel")
    del dist, label

    # ---- the SSSP cohort against its solo runs
    srcs = sample_sources(hg["deg"], SSSP_COHORT)
    (outs, crounds, stopped), t_co = wall_s(lambda: FR.frontier_sssp_batched(
        g, srcs, return_device=True))
    t_solo = 0.0
    for k, s in enumerate(srcs):
        (d1, r1), t = wall_s(lambda: FR.frontier_sssp(g, s,
                                                      return_device=True))
        t_solo += t
        check(torch.equal(outs[k].view(torch.int32), d1.view(torch.int32))
              and crounds[k] == r1, f"cohort member {k} (source {s}) "
              f"differs from its solo run")
    check(stopped == [None] * SSSP_COHORT, "a cohort member stopped")
    say(f"phase 8: K={SSSP_COHORT} frontier_sssp_batched: every row and "
        f"round count ({crounds}) bit-equal to its solo run; {t_co:.4f} s "
        f"against {t_solo:.4f} s for the solo runs")
    del outs, g
    torch.cuda.empty_cache()
    return peel


#: the mixed stream: an SSSP cohort, a WCC cohort, PageRank and the
#: engine's PageRank, under two tenants
SERVE_SSSP, SERVE_WCC, SERVE_PR, SERVE_DENSE = 4, 4, 2, 2
#: profiling on/off: each served K = 16 batch this many times, in turns
PROFILE_REPS = 2
#: one chunked-CSR upload on top of torch.cuda.memory_allocated: each of
#: the four tensors is rounded up by the caching allocator, a small one
#: to 512 B, a large one to its 2 MiB segment (the rest of a segment under
#: 1 MiB stays with the block), so the increase exceeds the prediction by
#: less than 4 * 2 MiB
ALLOC_SLACK = 4 * (2 << 20)


class ServedLaunches:
    """The three kernels' launches inside served runs only: each served
    segment zeroes the counts just before the scheduler runs and reads
    them just after its last job; direct comparison calls stay out."""

    def __init__(self, F, S):
        self.F, self.S = F, S
        self.total = {"frontier_round": 0, "batched_exhaust": 0,
                      "seg_scan": 0}

    def run(self, fn):
        F, S = self.F, self.S
        torch.cuda.synchronize()
        F.frontier_round.launches = 0
        F.batched_exhaust.launches = 0
        S.seg_scan.launches = 0
        out = fn()
        self.total["frontier_round"] += F.frontier_round.launches
        self.total["batched_exhaust"] += F.batched_exhaust.launches
        self.total["seg_scan"] += S.seg_scan.launches
        return out


def serve(sched, specs, wait_s: float = 300.0):
    """Submit ``specs`` to a paused scheduler, start it and wait for
    every job; returns ``(jobs, wall)``, the wall from the first submit
    to the last job's end."""
    t0 = time.time()
    jobs = [sched.submit(s) for s in specs]
    sched.start()
    for j in jobs:
        check(j.wait(wait_s), f"{j} did not finish in {wait_s} s")
    # the worker finalizes counters just after the last state change
    deadline = time.time() + 30
    while time.time() < deadline and sched.stats()["running_batch"]:
        time.sleep(0.001)
    return jobs, max(j.finished_at for j in jobs) - t0


def split(sched, job) -> dict:
    """Where a served job's time went, from its trace: queue (submit to
    start), the model call (its ``run`` span, the batch's device run
    and readback) and the rest of its execution (the batcher's result
    dicts and the scheduler's bookkeeping), in ms."""
    t = sched.trace_summary(job.id) or {}
    exec_ms = job.exec_seconds() * 1e3
    run_ms = t.get("device_ms", 0.0)
    return {"queue_ms": t.get("queue_ms"), "run_ms": run_ms,
            "rest_ms": round(exec_ms - run_ms, 3),
            "exec_ms": round(exec_ms, 3)}


def phase_serving_s22(F, P, FR, S, ref, card) -> dict:
    """The serving phase at s22, on phase 5's snapshot: the port's
    JobScheduler on the card drives a fused K = 16 BFS batch, a mixed
    stream under two tenants, two recovered jobs and the admission
    paths, under a phase-wide device profiler. Returns the kernels'
    served launches."""
    import shutil

    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.obs import devprof
    from titan_tpu_torch.olap.api import JobSpec
    from titan_tpu_torch.olap.recovery import FaultPlan
    from titan_tpu_torch.olap.serving import JobScheduler
    from titan_tpu_torch.olap.serving.hbm import snapshot_csr_bytes
    from titan_tpu_torch.utils.metrics import MetricManager

    snap, hg = ref["snap"], ref["hg"]
    n = snap.n
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_cache", "serving_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    launches = ServedLaunches(F, S)
    phase_m = MetricManager()
    prof = devprof.DeviceCostProfiler(metrics=phase_m).install()
    scheds = []

    def scheduler(**kw):
        s = JobScheduler(snapshot=snap, checkpoint_dir=root,
                         autostart=False, max_batch=BATCH_K,
                         metrics=MetricManager(), **kw)
        scheds.append(s)
        return s

    try:
        # ---- the chunked CSR: built once, measured, then cached
        if hasattr(snap, "_hybrid_csr_by_device"):
            del snap._hybrid_csr_by_device
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        a0 = torch.cuda.memory_allocated()
        g = P.build_chunked_csr(snap)
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated() - a0
        predicted = snapshot_csr_bytes(snap)
        check(0 <= grew - predicted < ALLOC_SLACK, f"the chunked CSR took "
              f"{grew} bytes, the ledger predicts {predicted}")
        check(P.build_chunked_csr(snap) is g, "a second build_chunked_csr "
              "call did not return the cached graph")
        say(f"phase 10: s{ENGINE_SCALE} chunked CSR built once: "
            f"torch.cuda.memory_allocated grew {grew} bytes, "
            f"snapshot_csr_bytes predicts {predicted} (+{grew - predicted}, "
            f"allocator rounding, limit {ALLOC_SLACK}); the second call "
            f"returned the cached tensors")

        # ---- 1. the fused K = 16 BFS batch
        srcs = sample_sources(hg["deg"], BATCH_K)
        bfs_specs = [JobSpec(kind="bfs", params={"source_dense": s})
                     for s in srcs]
        sched = scheduler()
        jobs, served_s = launches.run(lambda: serve(sched, bfs_specs))
        occ = sched._metrics.histogram("serving.batch.occupancy")
        check((occ.count, occ.max) == (1, float(BATCH_K)), f"occupancy "
              f"{occ.to_dict()}: not one batch of {BATCH_K}")
        for s, j in zip(srcs, jobs):
            check(j.state.value == "done" and j.batch_k == BATCH_K,
                  f"BFS job from {s}: {j.state.value}, batch_k {j.batch_k}"
                  f", {j.error}")
            check(np.array_equal(j.result["dist"], ref["bfs_rows"][s]),
                  f"served BFS from {s} differs from frontier_bfs_hybrid")
        resident = sched.ledger.resident_bytes()
        check(resident == predicted, f"ledger resident {resident}, "
              f"snapshot_csr_bytes {predicted}")
        # one K = 1 job on the running scheduler
        one = sched.submit(JobSpec(kind="bfs",
                                   params={"source_dense": srcs[0]}))
        check(one.wait(300) and one.state.value == "done", "K = 1 BFS job")
        lat1 = one.finished_at - one.submitted_at
        parts16, parts1 = split(sched, jobs[0]), split(sched, one)
        sched.close()
        # the batcher's host result work a BFS job: the reached count
        rows = [j.result["dist"] for j in jobs]
        _, reached_s = wall_s(lambda: [int((r < (1 << 30)).sum())
                                       for r in rows])
        (_, _, _), direct_s = wall_s(lambda: P.frontier_bfs_batched(snap,
                                                                    srcs))
        say(f"phase 10: served K={BATCH_K} BFS batch on {card}: "
            f"{served_s:.4f} s from the first submit to the last result, "
            f"one batch of {BATCH_K} (occupancy), every row equal to "
            f"frontier_bfs_hybrid (phase 5b's rows); frontier_bfs_batched "
            f"called directly on the same snapshot {direct_s:.4f} s, so the "
            f"serving layer adds {served_s - direct_s:.4f} s; one K=1 BFS "
            f"job on the running scheduler: {lat1:.4f} s submit to result; "
            f"ledger resident {resident} bytes = snapshot_csr_bytes; "
            f"first job of the batch {parts16}, the K=1 job {parts1}; the "
            f"batcher's host reached counts of the {BATCH_K} rows "
            f"{reached_s:.4f} s")

        # ---- 2. the mixed stream under two tenants
        nz = np.flatnonzero(np.asarray(hg["deg"]) > 0)
        sssp_src = [int(x) for x in nz[:SERVE_SSSP]]
        outdeg = np.maximum(snap.out_degree, 1).astype(np.float32)
        inv = np.where(snap.out_degree > 0, 1.0 / outdeg,
                       0.0).astype(np.float32)      # models/pagerank.run's
        specs = ([JobSpec(kind="sssp", tenant="alpha",
                          params={"source_dense": s}) for s in sssp_src]
                 + [JobSpec(kind="wcc", tenant="beta")] * SERVE_WCC
                 + [JobSpec(kind="pagerank", tenant="alpha",
                            params={"iterations": 20})] * SERVE_PR
                 + [JobSpec(kind="dense", tenant="beta", params={
                     "program": MP.PageRank(0.85, 20, 0.0), "n": n,
                     "inv_outdeg": inv})] * SERVE_DENSE)
        sched = scheduler()
        walls = []
        attribute = sched._attribute

        def record(group, wall, nbytes):     # every batch's own wall
            walls.append(wall)
            attribute(group, wall, nbytes)
        sched._attribute = record
        jobs, mixed_s = launches.run(lambda: serve(sched, specs))
        ts = sched.tenant_stats()["tenants"]
        m = sched._metrics
        parts = {f"{j.spec.kind}#{i}": split(sched, j)
                 for i, j in enumerate(jobs)
                 if i in (0, SERVE_SSSP, SERVE_SSSP + SERVE_WCC,
                          len(jobs) - 1)}
        sched.close()
        check(all(j.state.value == "done" for j in jobs),
              "mixed stream: " + ", ".join(f"{j.spec.kind} {j.state.value}"
                                           f" {j.error}" for j in jobs))
        ks = [j.batch_k for j in jobs]
        check(ks == [SERVE_SSSP] * SERVE_SSSP + [SERVE_WCC] * SERVE_WCC
              + [1] * (SERVE_PR + SERVE_DENSE), f"batch compositions {ks}")
        dev_s = sum(r["device_seconds"] for r in ts.values())
        check(abs(dev_s - sum(walls)) <= 1e-9 * max(sum(walls), 1.0),
              f"tenant device-seconds {dev_s} != batch walls {sum(walls)}")
        labeled = sum(c.count for _, c in m.children(
            "serving.jobs.completed"))
        check(labeled == m.counter_value("serving.jobs.completed")
              == len(jobs), "labeled completions do not sum to the total")
        for s, j in zip(sssp_src, jobs[:SERVE_SSSP]):
            d, r = FR.frontier_sssp(snap, s)
            check(np.array_equal(j.result["dist"].view(np.int32),
                                 d.view(np.int32))
                  and j.result["rounds"] == r,
                  f"served SSSP from {s} differs from frontier_sssp")
        (_, _, _), sssp_direct = wall_s(lambda: FR.frontier_sssp_batched(
            snap, sssp_src))
        (_, _, _), wcc_direct = wall_s(lambda: FR.frontier_wcc_batched(
            snap, SERVE_WCC))
        (lab, wr), wcc1 = wall_s(lambda: FR.frontier_wcc(snap))
        _, unique_s = wall_s(lambda: len(np.unique(lab)))
        for j in jobs[SERVE_SSSP:SERVE_SSSP + SERVE_WCC]:
            check(np.array_equal(j.result["labels"], lab)
                  and j.result["rounds"] == wr
                  and np.array_equal(lab, ref["labels"]),
                  "served WCC differs from frontier_wcc or scipy")
        rank, _ = FR.pagerank_dense(snap, iterations=20)
        pr_jobs = jobs[SERVE_SSSP + SERVE_WCC:][:SERVE_PR]
        pr_err = max(float(np.max(np.abs(j.result["rank"] - rank) / rank))
                     for j in pr_jobs)
        pr_bits = all(np.array_equal(j.result["rank"], rank)
                      for j in pr_jobs)
        check(pr_err <= FLOAT_SUM_RTOL, f"served pagerank differs from "
              f"pagerank_dense by {pr_err}")
        for j in jobs[-SERVE_DENSE:]:
            check(j.result["iterations"] == 20 and np.array_equal(
                j.result["rank"], ref["engine_rank"]), "served dense "
                "PageRank is not bit-equal to GPUGraphComputer.run")
        say(f"phase 10: mixed stream on {card}: {SERVE_SSSP} SSSP (one "
            f"cohort), {SERVE_WCC} WCC (one cohort), {SERVE_PR} pagerank, "
            f"{SERVE_DENSE} dense PageRank (20 supersteps) under tenants "
            f"alpha and beta in {mixed_s:.4f} s; batches {len(walls)}, "
            f"walls {[round(w, 4) for w in walls]} s; SSSP and WCC equal "
            f"to the direct calls (WCC to scipy too); pagerank within "
            f"{pr_err:.3g} of pagerank_dense (bit-equal: {pr_bits}; "
            f"index_add_ adds in no fixed order on the card); dense "
            f"bit-equal to phase 5's GPUGraphComputer.run; tenant "
            f"device-seconds {dev_s:.6f} = the batch walls' sum, labeled "
            f"completions sum to the total ({labeled}); direct calls: the "
            f"SSSP cohort {sssp_direct:.4f} s, the WCC cohort "
            f"{wcc_direct:.4f} s, one frontier_wcc {wcc1:.4f} s, the "
            f"batcher's host np.unique of one label array {unique_s:.4f} "
            f"s; per-job split {parts}")

        # ---- 3. recovery: a crashed BFS and a crashed dense PageRank
        rec_specs = [
            JobSpec(kind="bfs", params={"source_dense": srcs[1],
                                        "faults": FaultPlan(
                                            crash_at_round=2)},
                    checkpoint_every=1, max_retries=1,
                    retry_backoff_s=0.01),
            JobSpec(kind="dense", params={
                "program": MP.PageRank(0.85, 20, 0.0), "n": n,
                "inv_outdeg": inv,
                "faults": FaultPlan(crash_at_round=10)},
                checkpoint_every=5, max_retries=1, retry_backoff_s=0.01)]
        sched = scheduler()
        jobs, rec_s = launches.run(lambda: serve(sched, rec_specs))
        rm = sched._metrics
        sched.close()
        b, d = jobs
        check(all(j.state.value == "done" and j.attempt == 2 for j in jobs),
              "recovered jobs: " + ", ".join(
                  f"{j.state.value} attempt {j.attempt} {j.error}"
                  for j in jobs))
        check(rm.counter_value("serving.recovery.resumes") == 2,
              "recovery: not one resume a job")
        check(np.array_equal(b.result["dist"], ref["bfs_rows"][srcs[1]]),
              "recovered BFS differs from frontier_bfs_hybrid")
        check(np.array_equal(d.result["rank"], ref["engine_rank"]),
              "recovered dense PageRank is not bit-equal to the "
              "uninterrupted run")
        ck = rm.histogram("serving.recovery.checkpoint_ms").to_dict()
        say(f"phase 10: recovery on {card}: BFS crashed at level 2 "
            f"(checkpoint every level), dense PageRank at superstep 10 "
            f"(every 5); both done on attempt 2 with one resume each, "
            f"bit-equal to their uninterrupted runs, in {rec_s:.4f} s; "
            f"rounds_replayed BFS {b.rounds_replayed}, dense "
            f"{d.rounds_replayed}; {ck['count']} checkpoints, "
            f"checkpoint_ms mean {ck['mean']:.3f}, max {ck['max']:.3f}")

        # ---- 4. admission: a cancel and a deadline while paused
        sched = scheduler()
        c = sched.submit(JobSpec(kind="bfs", params={"source_dense": 0}))
        check(sched.cancel(c.id) and c.state.value == "cancelled",
              "a queued job did not cancel")
        e = sched.submit(JobSpec(kind="bfs", params={"source_dense": 0},
                                 deadline=time.time() + 0.05))
        time.sleep(0.1)
        sched.start()
        check(e.wait(60) and e.state.value == "expired",
              f"a job past its deadline went {e.state.value}")
        sched.close()
        h2d = phase_m.counter_value("device.xfer.h2d_bytes",
                                    {"site": "bfs.chunked_csr"})
        check(h2d == predicted, f"bfs.chunked_csr H2D {h2d} bytes across "
              f"the phase, one upload is {predicted}")
        say(f"phase 10: admission: a queued job cancelled, a job past its "
            f"deadline expired while paused; bfs.chunked_csr H2D "
            f"{h2d} bytes across the phase: one upload")

        # ---- 5. profiling: the kernels' children, then on against off
        ex = {k: phase_m.counter_value("device.exec.calls", {"kernel": k})
              for k in ("frontier_round", "batched_exhaust", "seg_scan")}
        check(all(ex.values()), f"device.exec.calls children {ex}")
        ms = {k: round(sum(c.child.total for _, c in phase_m.children(
            "device.exec.ms", {"kernel": k})), 3) for k in ex}
        prof.uninstall()
        walls_pf = {True: [], False: []}
        for on in (False, True, True, False)[:2 * PROFILE_REPS]:
            sched = scheduler(profiling=on)
            jobs, w = serve(sched, bfs_specs)
            sched.close()
            check(all(np.array_equal(j.result["dist"], ref["bfs_rows"][s])
                      for s, j in zip(srcs, jobs)), "profiled BFS rows")
            walls_pf[on].append(w)
            check(snap._hybrid_csr_by_device.get(g["dstT"].device) is g,
                  "the cached chunked CSR was rebuilt")
        on_s = sum(walls_pf[True]) / len(walls_pf[True])
        off_s = sum(walls_pf[False]) / len(walls_pf[False])
        say(f"phase 10: device.exec children (CUDA events over the phase): "
            f"calls {ex}, ms {ms}; the served K={BATCH_K} batch with the "
            f"profiler on {on_s:.4f} s, off {off_s:.4f} s (mean of "
            f"{PROFILE_REPS} each, in turns off/on/on/off): "
            f"{on_s / off_s:.3f}x (the JAX package's guard is 1.15x; "
            f"reported, not gated)")
    finally:
        for s in scheds:
            if not s.closed:
                s.close()
        prof.uninstall()
        shutil.rmtree(root, ignore_errors=True)
    check(all(launches.total.values()), f"a kernel was never launched "
          f"by the served runs: {launches.total}")
    say(f"phase 10: served launches {launches.total}")
    return {"launches": launches.total, "served_s": served_s,
            "direct_s": direct_s, "k1_s": lat1, "profile_on_s": on_s,
            "profile_off_s": off_s}


def sssp_round_split(trace) -> list[dict]:
    """Per round from a drained ``_trace_rounds``: the plan's seconds and
    the pushes' (from the end of this plan to the start of the next,
    whose drain waited for them)."""
    rows = []
    for i, (band, nf, m8, t, plan_s) in enumerate(trace):
        push = (trace[i + 1][3] - trace[i + 1][4] - t) \
            if i + 1 < len(trace) else 0.0
        rows.append({"round": i, "nf": nf, "m8": m8,
                     "plan_s": round(plan_s, 6), "push_s": round(push, 6)})
    return rows


def phase_frontier_s26(F, P, FR, g, hg, card) -> int:
    """Phase 9: bench.py's sssp_wcc stage on the s26 graph, then the
    checks. Returns the WCC peel's frontier_round launches."""
    from titan_tpu_torch.device import INF

    src = int(np.flatnonzero(np.asarray(hg["deg"]) > 0)[0])
    torch.cuda.reset_peak_memory_stats()
    trace = []
    g["_trace_rounds"] = trace
    g["_trace_plan_drain"] = True
    try:
        (dist, rounds), t_sssp = wall_s(lambda: FR.frontier_sssp(
            g, src, return_device=True))
    finally:
        del g["_trace_rounds"], g["_trace_plan_drain"]
    plans = np.asarray([r[4] for r in trace])
    split = sssp_round_split(trace)
    # ---- the WCC main path, the kernel counts from 0
    F.frontier_round.launches = 0
    (label, wrounds), t_wcc = wall_s(lambda: FR.frontier_wcc(
        g, return_device=True))
    peel = F.frontier_round.launches
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    check(peel > 0, "the WCC peel never launched frontier_round")
    say(f"phase 9: s{SCALE} frontier_sssp from {src} (bench.py's sssp_wcc, "
        f"traced and drained as bench.py runs it) on {card}: {rounds} "
        f"rounds in {t_sssp:.4f} s; plan seconds a round mean "
        f"{plans.mean():.6f}, p50 {np.median(plans):.6f}, max "
        f"{plans.max():.6f}, total {plans.sum():.6f} over {len(plans)} "
        f"plans; pushes {sum(r['push_s'] for r in split):.6f} s in all")
    say(f"phase 9: each SSSP plan (nf, m8, plan_s, push_s): "
        + json.dumps(split))
    say(f"phase 9: s{SCALE} frontier_wcc: {wrounds} rounds (BFS peel levels "
        f"included) in {t_wcc:.4f} s; frontier_round {peel} launches in "
        f"the peel; peak memory {peak / 2**30:.3f} GiB")
    t0 = time.time()
    nreach = check_sssp(FR, g, dist, src)
    ncomp = check_wcc(FR, g, label)
    check(torch.equal(dist < float(FR.FINF), label == label[src]),
          "SSSP's reached set is not the source's component")
    bfs_src = sample_sources(hg["deg"], NUM_SOURCES)[0]
    bfs, _ = P.frontier_bfs_hybrid(g, bfs_src, return_device=True)
    giant = label == label[bfs_src]
    check(torch.equal(bfs < INF, giant), "the giant label's set differs "
          "from what a BFS from phase 6's first source reaches")
    say(f"phase 9: SSSP checked by its {(g['q_total'] - 1) * 8} slot "
        f"tests ({nreach} reached, none can lower a distance, every reached "
        f"vertex has a tight in-edge); WCC checked by its edges and label "
        f"rules ({ncomp} components), the giant's {int(giant.sum())} "
        f"vertices equal to a BFS from {bfs_src}; checks "
        f"{time.time() - t0:.1f} s")
    del dist, label, bfs, giant
    torch.cuda.empty_cache()
    return peel


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from titan_tpu_torch import native
    from titan_tpu_torch.models import bfs_hybrid as P
    from titan_tpu_torch.models import frontier as FR
    from titan_tpu_torch.models import pagerank as PR
    from titan_tpu_torch.olap import graph500 as G
    from titan_tpu_torch.olap import snapshot as SN
    from titan_tpu_torch.olap.live import overlay as OV
    from titan_tpu_torch.ops import frontier as F
    from titan_tpu_torch.ops import seg_scan as S

    card = card_line()
    print(card, flush=True)
    t0 = time.time()
    builds = [Background(F.kernel_library), Background(F.exhaust_library),
              Background(S.kernel_library), Background(native.library)]
    for b in builds:
        b.result()
    say(f"phase 1: built frontier_round, batched_exhaust and seg_scan "
        f"(nvcc, sm_90a, one process each, all at once) and the native "
        f"Graph500 library in {time.time() - t0:.1f} s")
    for name, lib in (("frontier_round", F.kernel_library()),
                      ("batched_exhaust", F.exhaust_library()),
                      ("seg_scan", S.kernel_library())):
        say(f"phase 1: ptxas {name}: " + "; ".join(ptxas_lines(lib)))

    def host_build(scale):
        t = time.time()
        hg = G.load_or_build(scale, EDGE_FACTOR, seed=SEED, verbose=False)
        return hg, time.time() - t
    engine_build = Background(lambda: host_build(ENGINE_SCALE))
    main_build = Background(lambda: (engine_build.join(),
                                     host_build(SCALE))[1])

    phase_kernel_cases(F, G)
    phase_exhaust_cases(F)
    phase_seg_scan_cases(S)
    phase_seg_scan_rows(S)
    phase_small(F, P, G)
    ref = engine_references(engine_build)
    main_build.join()     # the timed phases run with the host otherwise idle
    seg_rec, superstep_s = phase_engine(S, P, G, ref, card)
    batched = phase_engine_batched(S, P, G, ref, card)
    ckpt_launches = phase_checkpoint(S, ref, card)
    seg_rec["launches_by_path"] = {"engine": seg_rec["launches"],
                                   "engine_batched": batched["launches"],
                                   "engine_checkpoint": ckpt_launches}
    seg_rec["launches"] = sum(seg_rec["launches_by_path"].values())
    seg_rec["rows"] = batched["rows"]
    peel22 = phase_frontier_s22(F, P, G, FR, PR, ref, card, superstep_s)
    served = phase_serving_s22(F, P, FR, S, ref, card)["launches"]
    seg_rec["launches_by_path"]["serving"] = served["seg_scan"]
    seg_rec["launches"] = sum(seg_rec["launches_by_path"].values())
    del ref               # and with it the s22 graph cached on the card
    torch.cuda.empty_cache()
    g, hg, rec = phase_main(F, P, G, main_build, card)
    replays, paths, sweep, x_rec = phase_batched(F, P, G, g, hg, card)
    peel26 = phase_frontier_s26(F, P, FR, g, hg, card)
    del g
    torch.cuda.empty_cache()
    phase_batched_small(F, P, G, SN, OV, card)
    rec["replays"] += replays
    rec["k_sweep"] = sweep
    rec["launches_by_path"] = {"bfs": rec["launches"], **paths,
                               "wcc_peel_s22": peel22,
                               "wcc_peel_s26": peel26,
                               "serving": served["frontier_round"]}
    rec["launches"] = sum(rec["launches_by_path"].values())
    x_rec["launches_by_path"]["serving"] = served["batched_exhaust"]
    x_rec["launches"] = sum(x_rec["launches_by_path"].values())
    print(json.dumps({"kernels": [rec, seg_rec, x_rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
