"""Multi-source fusion: execute compatible jobs as one batched device run
(the port's copy of ``titan_tpu/olap/serving/batcher.py``; every kind
routes to the port's own function, on the batcher's device).

The batcher is the execution half of the serving layer: given a group of
admitted jobs leased onto ONE snapshot, it

* fuses BFS jobs into a single ``[K, n]`` multi-source run
  (models/bfs_hybrid.frontier_bfs_batched) — the per-level plan and
  every edge-chunk gather are shared across the K jobs.
  Cancellation and timeout act through the per-job keep mask at level
  boundaries;
* fuses same-knob SSSP and WCC jobs into cohorts
  (models/frontier.frontier_sssp_batched / frontier_wcc_batched);
* runs everything else singly (sssp / pagerank / wcc frontier models,
  'dense' DensePrograms through olap/engine.run_single, 'callable' host
  delegations), honoring cancel-before-start.

The kernels mutate their state tensors in place, so every checkpoint
row is a host copy taken inside the callback, before the next level or
round runs. Results are plain dicts of host arrays; the full distance
arrays stay under keys the wire form omits (Job.to_wire) — callers
resolve per-target distances via ``params['targets']``. Readbacks count
on ``obs/devprof``'s ``frontier.result`` site.

Mesh placement (``Batcher(mesh=...)``, a ``parallel.mesh.LocalMesh``):
batched BFS groups run over the mesh, the leased snapshot placed once
through ``parallel/partition.place_batched_csr`` (its vertices in blocks,
one a mesh device) and driven block by block by ``frontier_bfs_batched``.
Only kind ``"bfs"`` (``_MESH_KINDS``) and only with no live overlay go
that way; ``would_mesh`` is the one predicate, which the scheduler's
per-device ledger charge reads too. The run span records ``meshed: D``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

import torch

from titan_tpu_torch.device import INF, cache_key, resolve_device
from titan_tpu_torch.obs import devprof
from titan_tpu_torch.olap.serving.jobs import Job

#: jobs of these kinds fuse into one batched run when they share a
#: snapshot — BFS through the [K, n] batched kernel, SSSP/WCC through
#: the per-member cohort driver (models/frontier._frontier_cohort)
BATCHABLE_KINDS = ("bfs", "sssp", "wcc")

#: kinds the mesh placement path understands (parallel/partition
#: places the BATCHED BFS layout only) — the would_mesh predicate and
#: the scheduler's per-device ledger accounting key off this, NOT off
#: BATCHABLE_KINDS, so adding cohort kinds cannot silently change what
#: the admission guard charges per device
_MESH_KINDS = ("bfs",)


def batch_key(spec) -> Optional[tuple]:
    """Grouping key: jobs with equal keys may fuse into one batch. The
    kind is always in the key (a mixed stream fuses into PER-ALGORITHM
    cohorts, never across kinds), plus every knob the fused run shares:
    ``max_levels`` for BFS (one shared level loop), the scheduler-mode
    knobs ``max_rounds``/``delta``/``quantile_mass`` for SSSP (the
    cohort runs each member's trajectory under cohort-wide mode knobs,
    so differing knobs must not fuse)."""
    if spec.kind not in BATCHABLE_KINDS:
        return None
    base = (spec.kind,
            tuple(spec.labels) if spec.labels is not None else None,
            bool(spec.directed))
    try:
        if spec.kind == "bfs":
            return base + (int(spec.params.get("max_levels", 1000)),)
        if spec.kind == "sssp":
            delta = spec.params.get("delta")
            qm = spec.params.get("quantile_mass")
            return base + (
                int(spec.params.get("max_rounds", 10_000)),
                float(delta) if delta is not None else None,
                int(qm) if qm is not None else None)
        return base          # wcc: no per-job kernel knobs
    except (TypeError, ValueError):
        return None      # junk knob values: run (and fail) alone


def _dense_source(snap, params: dict) -> int:
    """Resolve a job's source to a dense index: ``source_dense`` wins,
    else ``source`` is an original vertex id mapped through the
    snapshot. Raises ValueError for ANY malformed value (None, lists,
    non-numeric strings) — callers catch it per job; it must never
    escape as a TypeError that could take the worker thread down."""
    try:
        if "source_dense" in params:
            return int(params["source_dense"])
        if "source" in params:
            return snap.dense_of(int(params["source"]))
    except KeyError as e:                 # dense_of: unknown vertex
        raise ValueError(str(e)) from e
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad source value: {e}") from e
    raise ValueError("job params need 'source' (vertex id) or "
                     "'source_dense'")


def _epoch_token(snap, overlay):
    """Checkpoint-compatibility token: the snapshot epoch, widened with
    the overlay delta seq when a live overlay is active. Checkpoints
    resume only on an EXACT match (olap/recovery JobRecovery.latest) —
    overlay deltas between attempts would otherwise leak stale
    reachability into the resumed state (tombstones are not monotone),
    so a changed seq forces a clean restart instead."""
    e = getattr(snap, "epoch", None)
    if overlay is not None and not overlay.empty:
        return [e, overlay.seq]
    return e


def _host(x) -> np.ndarray:
    """A state array as a host copy of its own (device tensors are
    updated in place by the run that handed them over)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.array(x)


def _bfs_result(snap, dist_row: np.ndarray, levels: int, inf: int,
                params: dict) -> dict:
    reached = int((dist_row < inf).sum())
    out = {"levels": int(levels), "reached": reached, "n": int(dist_row.shape[0]),
           "dist": dist_row}
    targets = params.get("targets")
    if targets:
        td = {}
        for t in targets:
            try:
                d = int(dist_row[snap.dense_of(int(t))])
            except Exception:     # unknown vertex / malformed value —
                d = None          # a bad target is None, never a crash
            td[str(t)] = d if d is not None and d < inf else None
        out["targets"] = td
    return out


class Batcher:
    """Stateless executor over leased snapshots (the scheduler owns the
    queue, admission and leases), running every kind on ``device``
    (``None`` means CUDA).

    With ``mesh`` (a ``LocalMesh`` whose first device is ``device``),
    batched BFS cohorts run over the mesh (module doc); every other
    kind, and a BFS cohort under a live overlay, runs on ``device``."""

    def __init__(self, max_batch: int = 16, mesh=None, device=None):
        self.max_batch = max_batch
        self.device = resolve_device(device)
        if mesh is not None and cache_key(mesh.devices[0]) \
                != cache_key(self.device):
            # never move unmeshed work off the mesh's first device
            raise ValueError(f"the batcher runs on {self.device}, the "
                             f"mesh's first device is {mesh.devices[0]}")
        self.mesh = mesh

    def would_mesh(self, kind: str, overlay) -> bool:
        """THE meshed-execution predicate — the scheduler's per-device
        memory admission accounting queries this exact method, so the
        bytes the ledger charges and the layout this batcher actually
        uploads can never disagree."""
        return (self.mesh is not None
                and int(self.mesh.size) > 1
                and kind in _MESH_KINDS
                and (overlay is None or overlay.empty))

    def run_batch(self, jobs: list[Job], snap, overlay=None) -> None:
        """Kind-generic batch entry (the scheduler's one dispatch
        point): BFS groups go through the [K, n] batched kernel,
        SSSP/WCC groups through the frontier cohort driver. The
        scheduler's grouping key always carries the kind, so a group
        is single-kind by construction."""
        kind = jobs[0].spec.kind
        if kind == "bfs":
            self.run_bfs_batch(jobs, snap, overlay=overlay)
        elif kind in ("sssp", "wcc"):
            self.run_frontier_batch(jobs, snap, overlay=overlay)
        else:
            for job in jobs:
                self.run_single(job, snap, overlay=overlay)

    # -- batched BFS --------------------------------------------------------

    def run_bfs_batch(self, jobs: list[Job], snap, overlay=None) -> None:
        """Execute K BFS jobs as one batched [K, n] device run; each
        job's row is bit-equal to a sequential single-source run. Jobs
        whose source does not resolve fail up front (they never join the
        batch); cancellation/timeout drop individual jobs at level
        boundaries via the kernel's keep mask.

        Recovery plane: a retry attempt with a valid checkpoint resumes
        SOLO (its level counter differs from any fresh batchmate, and
        the batched kernel runs ONE shared level loop); fresh jobs — and
        retries restarting clean — fuse as usual. Checkpoints capture
        each active job's dist row at its cadence; an injected fault
        raising out of a level boundary fails the WHOLE batch (that is
        what a real worker death does), and each member then retries
        under its own policy."""
        t_fuse0 = time.time()
        fresh: list[Job] = []
        fresh_src: list[int] = []
        resumed: list[tuple[Job, int, object]] = []
        for job in jobs:
            try:
                src = _dense_source(snap, job.spec.params)
                # junk max_levels is a param error too — it must fail
                # permanently HERE, not detonate retryably mid-group
                int(job.spec.params.get("max_levels", 1000))
            except (KeyError, ValueError, TypeError) as e:
                # param errors are permanent: retrying cannot fix them
                job.fail(f"{type(e).__name__}: {e}", permanent=True)
                continue
            ck = None
            rec = job.recovery
            # adoption: any retry attempt, OR a FIRST attempt carrying
            # an idempotency key (fleet failover redispatch — the
            # logical job already ran elsewhere and its checkpoints
            # share the key, so attempt 1 here must resume, not
            # restart; a keyed first run with no checkpoint is simply
            # fresh, never counted restarted)
            if rec is not None and (job.attempt > 1
                                    or job.spec.idempotency_key):
                ck = rec.latest(kind="bfs",
                                epoch=_epoch_token(snap, overlay))
                if ck is not None:
                    rec.resumed(ck.round)
                elif job.attempt > 1:
                    rec.restarted()
            if ck is not None:
                resumed.append((job, src, ck))
            else:
                fresh.append(job)
                fresh_src.append(src)
        # fuse decision record (obs): K, shared-plan reuse, and why a
        # member ran solo — the amortization evidence per trace
        t_fuse1 = time.time()
        for job in fresh:
            if job.trace is not None:
                job.trace.event("fuse", t0=t_fuse0, t1=t_fuse1,
                                k=len(fresh), shared_plan=len(fresh) > 1)
        for job, _src, ck in resumed:
            if job.trace is not None:
                job.trace.event("fuse", t0=t_fuse0, t1=t_fuse1, k=1,
                                shared_plan=False,
                                solo="resumed from checkpoint "
                                     f"round {ck.round}")
        if fresh:
            self._bfs_group(fresh, fresh_src, snap, None, 0,
                            overlay=overlay)
        for job, src, ck in resumed:
            self._bfs_group([job], [src], snap,
                            np.asarray(ck.arrays["dist"])[None, :],
                            ck.round, overlay=overlay)

    def _bfs_group(self, runnable: list[Job], sources: list[int], snap,
                   init_dist, start_level: int, overlay=None) -> None:
        from titan_tpu_torch.models.bfs_hybrid import frontier_bfs_batched

        K = len(runnable)
        for job in runnable:
            job.batch_k = K
        started = time.time()
        dropped = [None] * K    # terminal state decided at a boundary
        n = snap.n if hasattr(snap, "n") else snap["n"]
        # mesh placement: overlay leases stay on one device (the overlay's
        # device buffers belong to the unsharded layout); everything else
        # runs over the mesh through the placed graph dict
        target = snap
        meshed = self.would_mesh("bfs", overlay)
        if meshed:
            from titan_tpu_torch.parallel.partition import place_batched_csr
            target = place_batched_csr(snap, self.mesh)
        # device-run spans (obs): one "run" per job covering the shared
        # level loop; per-level "round" children carry the job's OWN
        # frontier count — all host timestamps from the level callback
        # the kernel already makes (no extra syncs)
        runs = [job.trace.start("run", k=K, start_level=start_level,
                                **({"overlay_edges": overlay.count,
                                    "overlay_tombs": overlay.tomb_count}
                                   if overlay is not None
                                   and not overlay.empty else {}),
                                **({"meshed": int(self.mesh.size)}
                                   if meshed else {}))
                if job.trace is not None else None
                for job in runnable]
        # anchor AFTER the run spans open so the first round's window
        # nests inside them (children must not start before parents)
        prev_t = [time.time()]

        def on_level(level, nf):
            keep = np.ones(K, bool)
            now = time.time()
            for i, job in enumerate(runnable):
                if job.trace is not None and dropped[i] is None:
                    job.trace.event("round", parent=runs[i],
                                    t0=prev_t[0], t1=now, level=level,
                                    frontier=int(nf[i]))
                if dropped[i] is not None:
                    keep[i] = False
                    continue
                job.last_round = level
                rec = job.recovery
                if rec is not None and rec.faults is not None:
                    # deterministic fault injection (tests): raising
                    # here kills the batch, like a real worker death
                    rec.faults.check(level, job.attempt, snap)
                if job.cancel_requested:
                    dropped[i] = "cancel"
                    keep[i] = False
                elif job.spec.timeout_s is not None and \
                        now - started > job.spec.timeout_s:
                    dropped[i] = "timeout"
                    keep[i] = False
            prev_t[0] = now
            return keep if not keep.all() else None

        token = _epoch_token(snap, overlay)

        def checkpoint(level, dist, act):
            # dist is the run's copy at this boundary; each due row goes
            # to the host before the next level's sweep
            for i, job in enumerate(runnable):
                rec = job.recovery
                if rec is not None and act[i] and rec.due(level):
                    rec.save(level,
                             {"dist": _host(dist[i, :n])},
                             kind="bfs",
                             meta={"epoch": token})

        wants_ckpt = any(j.recovery is not None
                         and j.recovery.store is not None
                         for j in runnable)
        try:
            dist, levels, completed = frontier_bfs_batched(
                target, sources, max_levels=int(
                    runnable[0].spec.params.get("max_levels", 1000)),
                on_level=on_level,
                init_dist=init_dist, start_level=start_level,
                checkpoint=checkpoint if wants_ckpt else None,
                overlay=overlay, device=self.device)
        except Exception as e:
            for i, job in enumerate(runnable):
                if job.trace is not None:
                    job.trace.end(runs[i], error=f"{type(e).__name__}")
                job.fail(f"{type(e).__name__}: {e}")
            return
        inf = int(INF)
        for i, job in enumerate(runnable):
            if job.trace is not None:
                job.trace.end(runs[i], levels=int(levels[i]))
        for i, job in enumerate(runnable):
            if completed[i]:
                job.complete(_bfs_result(snap, dist[i], levels[i], inf,
                                         job.spec.params))
            elif dropped[i] == "timeout":
                job.time_out()
            else:
                job.mark_cancelled()

    # -- batched SSSP / WCC cohorts -----------------------------------------

    def run_frontier_batch(self, jobs: list[Job], snap,
                           overlay=None) -> None:
        """Execute a same-kind group of SSSP or WCC jobs as one fused
        cohort (models/frontier.frontier_sssp_batched /
        frontier_wcc_batched): per-member device state under ONE shared
        round loop with a single stacked plan readback per round, each
        member bit-equal to its sequential run. Fresh first attempts
        fuse; retry attempts and idempotency-keyed redispatches run
        SOLO through ``run_single`` (their adoption bookkeeping and —
        when a checkpoint matches — a round counter no fresh batchmate
        shares; the same split the batched BFS makes for resumes)."""
        t_fuse0 = time.time()
        kind = jobs[0].spec.kind
        fresh: list[Job] = []
        fresh_src: list[int] = []
        solo: list[Job] = []
        for job in jobs:
            src = 0
            if kind == "sssp":
                try:
                    src = _dense_source(snap, job.spec.params)
                except (KeyError, ValueError, TypeError) as e:
                    job.fail(f"{type(e).__name__}: {e}", permanent=True)
                    continue
            rec = job.recovery
            if rec is not None and (job.attempt > 1
                                    or job.spec.idempotency_key):
                solo.append(job)
            else:
                fresh.append(job)
                fresh_src.append(src)
        t_fuse1 = time.time()
        for job in fresh:
            if job.trace is not None:
                job.trace.event("fuse", t0=t_fuse0, t1=t_fuse1,
                                k=len(fresh), kind=kind,
                                shared_plan=len(fresh) > 1)
        for job in solo:
            if job.trace is not None:
                job.trace.event("fuse", t0=t_fuse0, t1=t_fuse1, k=1,
                                kind=kind, shared_plan=False,
                                solo="retry/redispatch attempt: may "
                                     "resume from a checkpoint")
        if fresh:
            self._frontier_group(fresh, fresh_src, snap,
                                 overlay=overlay)
        for job in solo:
            self.run_single(job, snap, overlay=overlay)

    def _frontier_group(self, runnable: list[Job], sources: list[int],
                        snap, overlay=None) -> None:
        from titan_tpu_torch.models.frontier import (FINF,
                                               frontier_sssp_batched,
                                               frontier_wcc_batched)

        kind = runnable[0].spec.kind
        K = len(runnable)
        for job in runnable:
            job.batch_k = K
        started = time.time()
        dropped = [None] * K    # terminal state decided at a boundary
        runs = [job.trace.start("run", kind=kind, k=K,
                                **({"overlay_edges": overlay.count,
                                    "overlay_tombs": overlay.tomb_count}
                                   if overlay is not None
                                   and not overlay.empty else {}))
                if job.trace is not None else None
                for job in runnable]
        # per-member round-window anchors, after the run spans open
        prev_t = [time.time()] * K

        def on_round(k, rounds):
            job = runnable[k]
            now = time.time()
            if job.trace is not None:
                job.trace.event("round", parent=runs[k],
                                t0=prev_t[k], t1=now, round=rounds)
                prev_t[k] = now
            job.last_round = rounds
            rec = job.recovery
            if rec is not None and rec.faults is not None:
                # raising here kills the WHOLE cohort — that is what a
                # real worker death does, same as the batched BFS; each
                # member then retries under its own policy
                rec.faults.check(rounds, job.attempt, snap)
            if job.cancel_requested:
                dropped[k] = "cancel"
                return False
            if job.spec.timeout_s is not None and \
                    now - started > job.spec.timeout_s:
                dropped[k] = "timeout"
                return False
            return True

        token = _epoch_token(snap, overlay)

        def ckpt(k, rounds, state):
            rec = runnable[k].recovery
            if rec is None or rec.store is None or not rec.due(rounds):
                return
            arrays = {"val": _host(state["val"]),
                      "val_exp": _host(state["val_exp"])}
            if kind == "sssp":
                rec.save(rounds, arrays, kind="sssp",
                         meta={"epoch": token,
                               "bucket_end": float(state["bucket_end"]),
                               "quantile_mass":
                                   int(state["quantile_mass"])})
            else:
                rec.save(rounds, arrays, kind="wcc",
                         meta={"epoch": token,
                               "levels": int(state["levels"])})

        wants_ckpt = any(j.recovery is not None
                         and j.recovery.store is not None
                         for j in runnable)
        params0 = runnable[0].spec.params
        try:
            if kind == "sssp":
                outs, rounds_l, stopped = frontier_sssp_batched(
                    snap, sources,
                    delta=params0.get("delta"),
                    quantile_mass=params0.get("quantile_mass"),
                    max_rounds=int(params0.get("max_rounds", 10_000)),
                    on_round=on_round,
                    checkpoint=ckpt if wants_ckpt else None,
                    overlay=overlay, device=self.device)
            else:
                outs, rounds_l, stopped = frontier_wcc_batched(
                    snap, K, on_round=on_round,
                    checkpoint=ckpt if wants_ckpt else None,
                    overlay=overlay, device=self.device)
        except Exception as e:
            for i, job in enumerate(runnable):
                if job.trace is not None:
                    job.trace.end(runs[i], error=f"{type(e).__name__}")
                job.fail(f"{type(e).__name__}: {e}")
            return
        for i, job in enumerate(runnable):
            if job.trace is not None:
                job.trace.end(runs[i], rounds=int(rounds_l[i]))
            if stopped[i] is not None:
                if dropped[i] == "timeout":
                    job.time_out()
                else:
                    job.mark_cancelled()
                continue
            arr = outs[i]
            devprof.count_d2h("frontier.result",
                              getattr(arr, "nbytes", 0))
            if kind == "sssp":
                job.complete({"rounds": int(rounds_l[i]),
                              "reached":
                                  int((arr < float(FINF)).sum()),
                              "dist": arr})
            else:
                job.complete({"rounds": int(rounds_l[i]),
                              "components": int(len(np.unique(arr))),
                              "labels": arr})

    # -- single execution ---------------------------------------------------

    def run_single(self, job: Job, snap, overlay=None) -> None:
        """One job alone (still async from the caller's view). The
        frontier kinds honor cancellation/timeout at ROUND boundaries
        through ``_frontier_run``'s on_round veto (models/frontier
        RoundInterrupted) — the single-execution analog of the batched
        kernel's level mask. The same boundaries drive the recovery
        plane (job.recovery): fault injection, checkpoint capture at
        the job's cadence, and — on a retry attempt — resume from the
        newest valid checkpoint (epoch-matched; otherwise clean
        restart). Param errors fail permanently (no retry)."""
        job.batch_k = 1
        kind = job.spec.kind
        params = dict(job.spec.params)
        params.pop("faults", None)       # injector is not a kernel param
        rec = job.recovery
        started = time.time()
        interrupted = {}

        if kind == "bfs":
            # bfs delegates wholesale — run_bfs_batch owns its own
            # resume bookkeeping (doing it here too would double-count
            # serving.recovery.resumes / rounds_replayed)
            self.run_bfs_batch([job], snap, overlay=overlay)
            return

        h = job.trace
        run_span = None
        if h is not None and kind != "callable":
            run_span = h.start(
                "run", kind=kind,
                **({"overlay_edges": overlay.count,
                    "overlay_tombs": overlay.tomb_count}
                   if overlay is not None and not overlay.empty
                   else {}))
        # round-window anchor: at/after the run span's start so round
        # children nest inside it
        prev_t = [time.time()]
        # per-round timeline (obs): pagerank/dense rounds are stamped
        # from the host callbacks below; sssp/wcc rounds come from
        # _frontier_run's existing mass-accounting trace instead — it
        # already carries frontier size / listed chunk mass / plan cost
        # per round at zero extra syncs (the stats readback happens
        # regardless), so the span timeline gets the band/plan story
        # for free
        trace_rounds = None
        _csr_trace_prev = None
        if h is not None and kind in ("sssp", "wcc"):
            from titan_tpu_torch.models.bfs_hybrid import build_chunked_csr
            _csr = build_chunked_csr(snap, self.device)
            _csr_trace_prev = _csr.get("_trace_rounds")
            trace_rounds = []
            _csr["_trace_rounds"] = trace_rounds

        def on_round(rounds):
            job.last_round = rounds
            if h is not None and trace_rounds is None:
                now = time.time()
                h.event("round", parent=run_span, t0=prev_t[0], t1=now,
                        round=rounds)
                prev_t[0] = now
            if rec is not None and rec.faults is not None:
                rec.faults.check(rounds, job.attempt, snap)
            if job.cancel_requested:
                interrupted["why"] = "cancel"
                return False
            if job.spec.timeout_s is not None and \
                    time.time() - started > job.spec.timeout_s:
                interrupted["why"] = "timeout"
                return False
            return True
        epoch = _epoch_token(snap, overlay)
        ck = None
        # adoption: any retry attempt, OR a first attempt under an
        # idempotency key (fleet failover redispatch: the checkpoint
        # store is shared and keyed, so attempt 1 here resumes the
        # logical job's newest checkpoint instead of restarting; keyed
        # first runs with no checkpoint are fresh, never "restarted")
        if rec is not None and kind != "callable" \
                and (job.attempt > 1 or job.spec.idempotency_key):
            ck = rec.latest(kind=kind, epoch=epoch)
            if ck is not None:
                rec.resumed(ck.round)
            elif job.attempt > 1:
                rec.restarted()
        wants_ckpt = rec is not None and rec.store is not None

        try:
            if kind == "sssp":
                from titan_tpu_torch.models.frontier import FINF, frontier_sssp
                try:
                    src = _dense_source(snap, params)
                except (KeyError, ValueError) as e:
                    job.fail(f"{type(e).__name__}: {e}", permanent=True)
                    return
                ckpt = None
                if wants_ckpt:
                    def ckpt(rounds, state):
                        if rec.due(rounds):
                            rec.save(rounds,
                                     {"val": _host(state["val"]),
                                      "val_exp": _host(state["val_exp"])},
                                     kind="sssp",
                                     meta={"epoch": epoch,
                                           "bucket_end":
                                               float(state["bucket_end"]),
                                           "quantile_mass":
                                               int(state["quantile_mass"])})
                resume = None
                if ck is not None:
                    resume = {"val": ck.arrays["val"],
                              "val_exp": ck.arrays["val_exp"],
                              "rounds": ck.round,
                              "bucket_end": ck.meta["bucket_end"],
                              "quantile_mass": ck.meta["quantile_mass"]}
                dist, rounds = frontier_sssp(
                    snap, src,
                    delta=params.get("delta"),
                    quantile_mass=params.get("quantile_mass"),
                    max_rounds=int(params.get("max_rounds", 10_000)),
                    on_round=on_round, checkpoint=ckpt, resume=resume,
                    overlay=overlay, device=self.device)
                devprof.count_d2h("frontier.result",
                                  getattr(dist, "nbytes", 0))
                dist = np.asarray(dist)
                job.complete({"rounds": int(rounds),
                              "reached": int((dist < float(FINF)).sum()),
                              "dist": dist})
            elif kind == "pagerank":
                from titan_tpu_torch.models.frontier import pagerank_dense
                ckpt = None
                if wants_ckpt:
                    def ckpt(it, state):
                        if rec.due(it):
                            rec.save(it,
                                     {"rank": _host(state["rank"])},
                                     kind="pagerank",
                                     meta={"epoch": epoch})
                resume = None
                if ck is not None:
                    resume = {"rank": ck.arrays["rank"], "it": ck.round}
                rank, iters = pagerank_dense(
                    snap, iterations=int(params.get("iterations", 20)),
                    damping=float(params.get("damping", 0.85)),
                    tol=params.get("tol"), on_round=on_round,
                    checkpoint=ckpt, resume=resume, overlay=overlay,
                    device=self.device)
                job.complete({"iterations": int(iters),
                              "rank": np.asarray(rank)})
            elif kind == "wcc":
                from titan_tpu_torch.models.frontier import frontier_wcc
                ckpt = None
                if wants_ckpt:
                    def ckpt(rounds, state):
                        if rec.due(rounds):
                            rec.save(rounds,
                                     {"val": _host(state["val"]),
                                      "val_exp": _host(state["val_exp"])},
                                     kind="wcc",
                                     meta={"epoch": epoch,
                                           "levels": int(state["levels"])})
                resume = None
                if ck is not None:
                    resume = {"val": ck.arrays["val"],
                              "val_exp": ck.arrays["val_exp"],
                              "rounds": ck.round,
                              "levels": ck.meta.get("levels", 0)}
                lab, rounds = frontier_wcc(snap, on_round=on_round,
                                           checkpoint=ckpt, resume=resume,
                                           overlay=overlay,
                                           device=self.device)
                devprof.count_d2h("frontier.result",
                                  getattr(lab, "nbytes", 0))
                lab = np.asarray(lab)
                job.complete({"rounds": int(rounds),
                              "components": int(len(np.unique(lab))),
                              "labels": lab})
            elif kind == "dense":
                from titan_tpu_torch.olap.engine import run_single
                program = params.pop("program")
                ckpt = None
                every = 0
                if rec is not None and (wants_ckpt
                                        or rec.faults is not None):
                    # dense programs have no on_round veto; the chunk
                    # boundary is the only host hook, so faults fire
                    # here — and a fault plan WITHOUT a store still
                    # needs the chunked loop (every=1) to get hooks
                    every = rec.every if wants_ckpt else 1

                    def ckpt(it, state):
                        job.last_round = it
                        if h is not None:
                            now = time.time()
                            h.event("round", parent=run_span,
                                    t0=prev_t[0], t1=now, round=it)
                            prev_t[0] = now
                        if rec.faults is not None:
                            rec.faults.check(it, job.attempt, snap)
                        if wants_ckpt and rec.due(it):
                            rec.save(it,
                                     {k: _host(v)
                                      for k, v in state.items()},
                                     kind="dense",
                                     meta={"epoch": epoch})
                resume = None
                if ck is not None:
                    resume = {"state": ck.arrays, "iteration": ck.round}
                res = run_single(
                    program, snap, params, device=self.device,
                    resume=resume, checkpoint=ckpt,
                    checkpoint_every=every)
                job.complete({"iterations": res.iterations,
                              **{k: np.asarray(v) for k, v in res.items()}})
            elif kind == "callable":
                job.complete({"value": params["fn"]()})
            else:
                job.fail(f"unknown job kind {kind!r}", permanent=True)
        except Exception as e:
            from titan_tpu_torch.models.frontier import RoundInterrupted
            if isinstance(e, RoundInterrupted):
                if interrupted.get("why") == "timeout":
                    job.time_out()
                else:
                    job.mark_cancelled()
            else:
                job.fail(f"{type(e).__name__}: {e}")
        finally:
            if h is not None:
                if trace_rounds is not None:
                    # bridge _frontier_run's per-round tuples
                    # (band, frontier, chunk_mass, t_plan_done, plan_s)
                    # into the span timeline, then detach the hook from
                    # the snapshot's cached CSR
                    t_prev = run_span.t_start if run_span is not None \
                        else started
                    for i, (band, nf, m8, t, plan_s) in \
                            enumerate(trace_rounds):
                        extra = {"band": float(band)} \
                            if 0.0 < float(band) < 1e30 else {}
                        h.event("round", parent=run_span, t0=t_prev,
                                t1=t, round=i, frontier=int(nf),
                                chunk_mass=int(m8),
                                plan_ms=round(plan_s * 1e3, 3), **extra)
                        t_prev = t
                    if _csr_trace_prev is None:
                        _csr.pop("_trace_rounds", None)
                    else:
                        _csr["_trace_rounds"] = _csr_trace_prev
                if run_span is not None:
                    h.end(run_span, rounds=int(job.last_round))
