#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # both main paths at their full sizes

Phases, each of which raises on failure:

1. print the card's name and power limit; build the kernels from the
   sources in the checkout (``nvcc`` for ``csrc/frontier_round.cu`` and
   ``csrc/seg_scan.cu``, ``g++`` for the native Graph500 library), all
   at once; start the host builds of the two Graph500 graphs (scale 22,
   then scale 26) in the background;
2. hold the ``frontier_round`` CUDA kernel bit-equal to its plain PyTorch
   version on the card: K in {1, 3}, lanes in {2, 8}, tbits absent and
   given, C in {70, 2^20}, a case with Q > 2^28 (64-bit offsets), one
   with C = 3*2^22 + 4099 (a scan over seven tiles), and K = 5 with
   out-of-range columns, parents and slots (the clamps);
3. hold the ``seg_scan`` CUDA kernel against its plain PyTorch version on
   the card, for every combine (sum, min, max) and type (float32,
   int32): E in {1, 70, a tile - 1, a tile, a tile + 1, 2^20,
   3*2^22 + 4099} with random segment starts, one segment spanning every
   tile (a pure carry chain), every element its own segment, and
   ``flags[0]`` False. Exact except float32 sums (``FLOAT_SUM_RTOL``);
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
   ``torch.segment_reduce``, and the superstep's parts are timed;
6. the BFS main path at the full scale: native R-MAT host build, upload,
   direction-optimizing BFS from sources sampled by bench.py's rule (one
   warm-up run, best of 3 per source), TEPS as bench.py computes it, and
   Graph500's validation rules checked on the card; then the kernel's
   widest main-path call is replayed to time it against its plain
   version and its bound.

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits 1 and prints no result.
"""

from __future__ import annotations

import json
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
#: float32 sums: |kernel - plain| <= FLOAT_SUM_RTOL * (the scan of |x|).
#: The kernel adds in tile order (16 in a thread, a warp tree, a block
#: tree, the carry chain) and the plain version in Hillis-Steele order;
#: each order's error is at most its depth (under 80 adds here) times
#: float32's 2^-24 times the scan of |x|, so the two differ by under
#: 1e-5 of it.
FLOAT_SUM_RTOL = 1e-5
#: PageRank at s22 against float64: max |r32 - r64| / r64. Each float32
#: superstep's sums err by at most about 80 * 2^-24 (5e-6) relative (the
#: messages are positive); PageRank contracts by alpha = 0.85 a step, so
#: 20 steps accumulate under 5e-6 / 0.15 = 3.3e-5.
PAGERANK_RTOL = 1e-4


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
    """[K, 8*nb] bool -> [K, nb] uint8 little-endian bitmaps."""
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], device=bits.device)
    K = bits.shape[0]
    return (bits.view(K, -1, 8).long() * w).sum(-1).to(torch.uint8)


def round_inputs(gen, K, C, Q, n_val, masked, high_cols=False, junk=False):
    """Random round inputs on the card. ``high_cols`` puts half the
    columns near Q (so lane*Q + col and col*8 + lane pass 2^31 when Q
    does 2^28); ``junk`` puts columns, parents and slots out of range, to
    hold the kernel's clamps to the plain version's."""
    dev = "cuda"

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    cols = ri(-Q, 2 * Q, (C,)) if junk else ri(0, Q, (C,))
    if high_cols:
        cols[::2] = Q - 1 - ri(0, min(Q, 1 << 24), (C - C // 2,))
    nb = (n_val + 9) // 8
    lo, hi = (-64, n_val + 512) if junk else (0, n_val + 1)
    tb = Q // 2 if junk else Q
    return dict(
        cols=cols,
        undec=torch.rand((K, C), generator=gen, device=dev) < 0.7,
        has_more=torch.rand((C,), generator=gen, device=dev) < 0.6,
        pay0=ri(0, n_val, (C,)), pay1=ri(0, 8, (C,)),
        fbits=pack_rows(torch.rand((K, nb * 8), generator=gen,
                                   device=dev) < 0.15),
        tbits=(torch.randint(0, 256, (tb,), generator=gen, device=dev,
                             dtype=torch.uint8) if masked else None),
        dstT=ri(lo, hi, (8, Q)))


def call(fn, a, lanes, fill0=-7, fill1=-9):
    return fn(a["cols"], a["undec"], a["has_more"], a["pay0"], a["pay1"],
              a["fbits"], a["tbits"], a["dstT"], lanes=lanes, fill0=fill0,
              fill1=fill1)


def max_abs_err(got, ref) -> int:
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(got, ref))


def phase_kernel_cases(F) -> None:
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(K, lanes, masked, C, C + 31, 1 << 20, False, False)
             for C in (70, 1 << 20) for K in (1, 3) for lanes in (2, 8)
             for masked in (False, True)]
    q_big = (1 << 28) + (1 << 24)          # 8*Q and Q*8 pass 2^31
    cases.append((1, 2, True, 1 << 20, q_big, 1 << 26, True, False))
    # 49,169 block counts: seven scan tiles of 8192, the last with 17
    cases.append((1, 2, False, (3 << 22) + 4099, 1 << 22, 1 << 22, False,
                  False))
    cases += [(5, lanes, True, 100003, 4099, 1000, False, True)
              for lanes in (2, 8)]
    launches0 = F.frontier_round.launches
    k_total = p_total = 0.0
    for K, lanes, masked, C, Q, n_val, high, junk in cases:
        a = round_inputs(gen, K, C, Q, n_val, masked, high, junk)
        got = call(F.frontier_round, a, lanes)
        ref = call(F.frontier_round_reference, a, lanes)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        k_ms = cuda_ms(lambda: call(F.frontier_round, a, lanes), 5)
        p_ms = cuda_ms(lambda: call(F.frontier_round_reference, a, lanes), 2)
        say(f"frontier_round K={K} lanes={lanes} "
            f"tbits={'given' if masked else 'none'} C={C} Q={Q} "
            f"{'out-of-range inputs ' if junk else ''}nsur={int(got[3])}: "
            f"{'bit-equal' if err == 0 else f'DIFFERS by {err}'}; "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        check(err == 0, "frontier_round differs from its plain version")
        check(round_bytes(a, lanes)["nsur"] == int(got[3]),
              "the byte model's survivor count differs from the kernel's")
        k_total, p_total = k_total + k_ms, p_total + p_ms
        del a, got, ref
    torch.cuda.empty_cache()
    say(f"phase 2: frontier_round bit-equal to its plain version in "
        f"{len(cases)}/{len(cases)} cases (tolerance 0: every output is "
        f"an integer), {F.frontier_round.launches - launches0} launches; "
        f"kernel {k_total:.4f} ms against plain {p_total:.4f} ms, summed "
        f"over one call of each case")


def seg_inputs(gen, e: int, dtype, density: float, first: bool = True):
    """Random scan inputs on the card: values uniform in [-1, 1) or over
    the whole int32 range, segment starts with ``density``, and
    ``flags[0]`` set to ``first``."""
    if dtype == torch.float32:
        values = torch.rand((e,), generator=gen, device="cuda") * 2 - 1
    else:
        values = torch.randint(-2**31, 2**31, (e,), generator=gen,
                               device="cuda", dtype=torch.int32)
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
    cases += [(big, 0.0, False, "one segment spanning every tile"),
              (big, 1.0, True, "every element its own segment"),
              (1 << 20, 1e-3, False, "flags[0] False")]
    launches0 = S.seg_scan.launches
    k_total = p_total = 0.0
    n_cases = 0
    for dtype in (torch.float32, torch.int32):
        for combine in S.COMBINES:
            for e, density, first, what in cases:
                values, flags = seg_inputs(gen, e, dtype, density, first)
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
    torch.cuda.empty_cache()
    say(f"phase 3: seg_scan agrees with its plain version in "
        f"{n_cases}/{n_cases} cases (min, max and int32 sums exact; "
        f"float32 sums within {FLOAT_SUM_RTOL:g} of the scan of |x|), "
        f"bit-equal run to run, {S.seg_scan.launches - launches0} "
        f"launches; kernel {k_total:.4f} ms against plain {p_total:.4f} ms, "
        f"summed over one call of each case")


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
    PyTorch call) timed beside the port's combine."""
    got = S.seg_scan(msg, g.flags, "sum")
    ref = S.seg_scan_reference(msg, g.flags, "sum")
    err = scan_error(S, got, ref, msg, g.flags, "sum")
    ms = cuda_ms(lambda: S.seg_scan(msg, g.flags, "sum"), 20, warmup=2)
    plain_ms = cuda_ms(lambda: S.seg_scan_reference(msg, g.flags, "sum"), 3)

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
    return {"E": e, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "combine_ms": combine_ms, "library_ms": library_ms,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


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
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bytes']} bytes at 3.35 TB/s: "
        f"values and flags read once, out written once); the whole "
        f"combine {rec['combine_ms']:.4f} ms against torch.segment_reduce "
        f"{rec['library_ms']:.4f} ms")
    say(f"phase 5: one PageRank superstep on {card}, device ms: "
        + json.dumps(parts))
    return {**SEG_KERNEL, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": "bytes", "library_ms": rec["library_ms"]}


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


def round_bytes(a, lanes: int) -> dict:
    """The bytes one round must move for these inputs, each input read
    once and each output written once. A read that depends on the data
    counts the 32-byte sectors this call's data needs: ``cols`` and the
    leading ``lanes`` rows of ``dstT`` for candidates some job still
    wants; the other rows for those some job missed in the narrow lanes;
    the frontier-bitmap bytes of the parents tested; ``has_more`` for the
    candidates that missed in every lane; ``pay0``/``pay1`` for the
    survivors. ``undec`` is read whole, and ``found`` and the two
    compacted lists are written whole. Also returns the survivor count
    this model finds, which must equal the kernel's ``nsur``."""
    dstT, fb, tb, undec = a["dstT"], a["fbits"], a["tbits"], a["undec"]
    K, C = undec.shape
    Q, nb = dstT.shape[1], fb.shape[1]
    dev = dstT.device
    col = a["cols"].long().clamp(0, Q - 1)
    j = torch.arange(C, device=dev)
    live = undec.any(0)
    lane = torch.arange(8, device=dev)[:, None]
    if tb is None:
        open_ = torch.ones((8, C), dtype=torch.bool, device=dev)
    else:
        w = tb[col.clamp(max=tb.numel() - 1)].int()   # slot col*8+l: byte col
        open_ = ((w[None] >> lane) & 1) == 0
    fb_offsets = []

    def test(l0, l1, want):
        """Hits of lanes [l0, l1) for the [K, C] candidates in ``want``."""
        par = dstT[l0:l1][:, col]
        byte = (par >> 3).long().clamp(0, nb - 1)
        tested = want[:, None, :] & open_[l0:l1][None]       # [K, L, C]
        kk = torch.arange(K, device=dev)[:, None, None] * nb
        fb_offsets.append((kk + byte[None]).expand_as(tested)[tested])
        bit = (fb[:, byte].int() >> (par & 7)[None]) & 1
        return (tested & (bit > 0)).any(1)

    hit = test(0, lanes, undec)
    missed = undec & ~hit
    wide = missed.any(0) if lanes < 8 else torch.zeros_like(live)
    if lanes < 8:
        missed = missed & ~test(lanes, 8, missed)
    out_miss = missed.any(0)
    surv = out_miss & a["has_more"]
    dstT_b = sum(sector_bytes(l * Q + col[live if l < lanes else wide], 4)
                 for l in range(8))
    nbytes = (sector_bytes(j[live], 4) + K * C + dstT_b
              + sector_bytes(torch.cat(fb_offsets), 1)
              + (0 if tb is None else sector_bytes(col[live], 1))
              + sector_bytes(j[out_miss], 1) + 2 * sector_bytes(j[surv], 4)
              + K * C + 8 * C + 4)
    return {"bytes": nbytes, "dstT_bytes": dstT_b, "nsur": int(surv.sum())}


def heavy_call_record(F, args, kw):
    """Replay the widest main-path call: bit-equality, times, bound."""
    a = dict(zip(("cols", "undec", "has_more", "pay0", "pay1", "fbits",
                  "tbits", "dstT"), args))
    got = F.frontier_round(*args, **kw)
    ref = F.frontier_round_reference(*args, **kw)
    err = max_abs_err(got, ref)
    check(err == 0, "frontier_round differs from its plain version at the "
          "main path's widest call")
    ms = cuda_ms(lambda: F.frontier_round(*args, **kw), 10, warmup=2)
    plain_ms = cuda_ms(lambda: F.frontier_round_reference(*args, **kw), 3)
    K, C = a["undec"].shape
    work = round_bytes(a, kw["lanes"])
    check(work["nsur"] == int(got[3]), "the byte model's survivor count "
          "differs from the kernel's")
    return {"C": C, "K": K, "nsur": int(got[3]), "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": work["bytes"] / HBM_BYTES_PER_S * 1e3, **work}


def phase_main(F, P, G, host_build, card) -> dict:
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
    # one traced run: CUDA events around every frontier_round call, and
    # the widest call's inputs kept for the replay below
    real = P.frontier_round
    events, widest = [], {}

    def traced(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*args, **kw)
        e1.record()
        events.append((e0, e1))
        if args[0].shape[0] > widest.get("C", -1):
            widest.update(C=args[0].shape[0], args=args, kw=kw)
        return out

    P.frontier_round = traced
    try:
        _, traced_levels, traced_s = bfs(srcs[0])
    finally:
        P.frontier_round = real
    kernel_s = sum(e0.elapsed_time(e1) for e0, e1 in events) / 1e3

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

    for r in per_source:
        validate(g, r.pop("dist"), r["source"], INF)
    teps = len(per_source) / sum(1.0 / r["teps"] for r in per_source)
    say(f"phase 6: Graph500 s{SCALE} ef{EDGE_FACTOR} on {card}: "
        f"TEPS {teps:.6g} (harmonic mean over {len(per_source)} "
        f"sources, best of {REPS}); per source "
        + json.dumps(per_source))
    say(f"phase 6: Graph500 validation passed for every source; "
        f"frontier_round launches {launches} over {runs} BFS runs; "
        f"traced run {traced_s:.4f} s, {len(events)} rounds, kernel "
        f"{kernel_s:.4f} s = {100 * kernel_s / traced_s:.1f}% of it "
        f"({traced_levels} levels)")
    rec = heavy_call_record(F, widest["args"], widest["kw"])
    say(f"phase 6: widest frontier_round call C={rec['C']} "
        f"nsur={rec['nsur']}: bit-equal to the plain version "
        f"(max_abs_err {rec['max_abs_err']}, tolerance 0); kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bytes']} bytes at 3.35 TB/s, "
        f"{rec['dstT_bytes']} of them dstT sectors; the survivor count of "
        f"the byte model equals nsur)")
    return {**KERNEL, "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": "bytes",
            "library_ms": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from titan_tpu_torch import native
    from titan_tpu_torch.models import bfs_hybrid as P
    from titan_tpu_torch.olap import graph500 as G
    from titan_tpu_torch.ops import frontier as F
    from titan_tpu_torch.ops import seg_scan as S

    card = card_line()
    print(card, flush=True)
    t0 = time.time()
    builds = [Background(F.kernel_library), Background(S.kernel_library),
              Background(native.library)]
    for b in builds:
        b.result()
    say(f"phase 1: built frontier_round and seg_scan (nvcc, sm_90a) and "
        f"the native Graph500 library in {time.time() - t0:.1f} s")

    def host_build(scale):
        t = time.time()
        hg = G.load_or_build(scale, EDGE_FACTOR, seed=SEED, verbose=False)
        return hg, time.time() - t
    engine_build = Background(lambda: host_build(ENGINE_SCALE))
    main_build = Background(lambda: (engine_build.join(),
                                     host_build(SCALE))[1])

    phase_kernel_cases(F)
    phase_seg_scan_cases(S)
    phase_small(F, P, G)
    ref = engine_references(engine_build)
    main_build.join()     # the timed phases run with the host otherwise idle
    seg_rec = phase_engine(S, P, G, ref, card)
    del ref               # and with it the s22 graph cached on the card
    torch.cuda.empty_cache()
    rec = phase_main(F, P, G, main_build, card)
    print(json.dumps({"kernels": [rec, seg_rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
