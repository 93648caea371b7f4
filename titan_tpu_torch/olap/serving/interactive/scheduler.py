"""InteractiveLane: the low-latency execution lane for point queries (port
of ``titan_tpu/olap/serving/interactive/scheduler.py``).

A dedicated worker + micro-batcher that BYPASSES the heavy OLAP heap (no
priorities, no retry plane, no checkpoints: a point query answers in
milliseconds or answers with its error) while still flowing through the
owning ``JobScheduler``'s shared planes:

* **snapshot pool + HBM ledger**: groups lease the same pool the heavy
  queue uses, and the graph image (or the ``out()`` orientation's
  reversed CSR) is reserved and pinned on the same ledger for the run;
* **tenant quotas**: every request passes ``TenantAccounting.admit``
  under the scheduler's quota table and enforce flag (enforced
  violations raise ``QuotaExceeded``), and the fused batch's wall is
  split over its members' tenants;
* **tracing**: one trace a batch (``traverse-<seq>``) with ``fuse`` and
  ``device_cost`` events;
* **device-cost profiler**: each batch runs inside a profiler window.

The sweeps run on the scheduler's device (``None`` means CUDA): the
hops batch through ``frontier_round`` and ``batched_exhaust``, the
personalized PageRank through ``pagerank_personalized_batched``.

Metrics (``serving.interactive.*``):
  serving.interactive.requests     admitted lane requests ({tenant})
  serving.interactive.fallbacks    loud interpreter fallbacks
  serving.interactive.batches      executed fused device runs
  serving.interactive.fuse_k       histogram: members per executed batch
  serving.interactive.wait_ms      histogram: fuse-window wait a request
  serving.interactive.latency_ms   histogram ({tenant}): submit -> reply
  serving.interactive.ppr_users    personalized-PageRank rows served

A fixed snapshot answers every label set (``pool.SnapshotPool.acquire``,
as in the JAX package): a single-label chain on ``JobScheduler(
snapshot=...)`` sweeps every edge (ROADMAP queue 3, reference side).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

import numpy as np
import torch

from titan_tpu_torch.device import next_pow2
from titan_tpu_torch.models.bfs_hybrid import (build_chunked_csr,
                                               frontier_bfs_batched)
from titan_tpu_torch.models.pagerank import (pagerank_personalized_batched,
                                             top_k_per_user)
from titan_tpu_torch.obs import devprof
from titan_tpu_torch.olap.serving.hbm import (AdmissionError,
                                              chunked_csr_bytes,
                                              snapshot_csr_bytes)
from titan_tpu_torch.olap.serving.interactive.collector import (
    DEFAULT_MAX_FUSE, DEFAULT_WINDOW_S, Collector, InteractiveRequest)
from titan_tpu_torch.olap.serving.interactive.compile import (
    DEFAULT_MAX_DEPTH, Direction, FallbackToInterpreter, PPRPlan,
    TraversalPlan, hop_label_masks, reversed_chunked_csr)
from titan_tpu_torch.olap.serving.tenants import (QuotaExceeded,
                                                  effective_tenant)
from titan_tpu_torch.ops.compaction import compact_ids

_batch_seq = itertools.count(1)


class InteractiveLane:
    """See module doc. One lane per JobScheduler
    (``JobScheduler.interactive()``); constructible on its own for
    tests."""

    def __init__(self, scheduler, *,
                 window_s: float = DEFAULT_WINDOW_S,
                 max_fuse: int = DEFAULT_MAX_FUSE,
                 max_depth: int = DEFAULT_MAX_DEPTH,
                 autostart: bool = True):
        self.sched = scheduler
        self.device = scheduler.device
        self._metrics = scheduler._metrics
        self.max_depth = int(max_depth)
        self.collector = Collector(window_s=window_s, max_fuse=max_fuse)
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "InteractiveLane":
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._run,
                                            name="serving-interactive",
                                            daemon=True)
            self._worker.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        self._closed = True
        self.collector.close()
        if self._worker is not None:
            self._worker.join(timeout)

    @property
    def closed(self) -> bool:
        return self._closed

    def stats(self) -> dict:
        return {"queue_depth": self.collector.depth(),
                "window_s": self.collector.window_s,
                "max_fuse": self.collector.max_fuse,
                "max_depth": self.max_depth}

    # -- submission ----------------------------------------------------------

    def submit(self, plan, tenant: Optional[str] = None,
               timeout_s: float = 30.0) -> dict:
        """Blocking point-query execution. Returns the response envelope;
        raises QuotaExceeded (an enforced quota violation),
        FallbackToInterpreter (the loud unsupported-at-run-time path:
        the caller reruns on the dsl interpreter), or the member's
        error."""
        if self._closed:
            raise RuntimeError("interactive lane is closed")
        tenant = self._admit(tenant)
        req = InteractiveRequest(plan, tenant)
        state = "failed"
        try:
            if isinstance(plan, TraversalPlan) \
                    and plan.depth > self.max_depth:
                # inside the admitted section: a depth-ceiling fallback
                # is still this tenant's traffic
                self._metrics.counter(
                    "serving.interactive.fallbacks").inc()
                state = "fallback"
                raise FallbackToInterpreter(
                    f"depth {plan.depth} past the lane ceiling "
                    f"{self.max_depth} — an analytics-depth chain "
                    "belongs on the heavy queue or the interpreter")
            self.collector.submit(req)
            if not req.wait(timeout_s):
                raise RuntimeError(
                    f"interactive request timed out after {timeout_s}s")
            if req.error is not None:
                if isinstance(req.error, FallbackToInterpreter):
                    state = "fallback"
                    self._metrics.counter(
                        "serving.interactive.fallbacks").inc()
                raise req.error
            state = "completed"
            self._metrics.histogram(
                "serving.interactive.latency_ms",
                labels={"tenant": tenant}).update(
                (time.time() - req.submitted_at) * 1e3)
            self._metrics.histogram(
                "serving.interactive.wait_ms").update(req.wait_ms)
            return req.result
        finally:
            self.sched.tenants.finished(tenant, state)

    def _admit(self, tenant: Optional[str]) -> str:
        """The lane's quota gate, shared by compiled submits and
        interpreter fallbacks: atomic tenant admission under the
        scheduler's quota table; enforced violations raise QuotaExceeded,
        shadow-mode ones count throttled. Returns the effective tenant;
        the caller MUST balance it with ``tenants.finished``."""
        tenant = effective_tenant(tenant)
        sched = self.sched
        # an enforcing autotune controller's tenant shed scales the
        # configured quota here too
        quota = sched.quotas.get(tenant)
        if sched.controller is not None:
            quota = sched.controller.scaled_quota(tenant, quota)
        why = sched.tenants.admit(tenant, quota, sched.enforce_quotas)
        if why is not None and sched.enforce_quotas:
            self._metrics.counter("serving.tenant.rejected",
                                  labels={"tenant": tenant}).inc()
            raise QuotaExceeded(f"tenant {tenant!r}: {why}")
        if why is not None:
            self._metrics.counter("serving.tenant.throttled",
                                  labels={"tenant": tenant}).inc()
        self._metrics.counter("serving.interactive.requests",
                              labels={"tenant": tenant}).inc()
        return tenant

    def account_fallback(self, tenant: Optional[str] = None):
        """Admission and accounting for a COMPILE-TIME interpreter
        fallback: the same quota gate as compiled submits. Counts the
        fallback and returns a ``done(state)`` callable the caller MUST
        invoke exactly once after the interpreter run."""
        tenant = self._admit(tenant)
        self._metrics.counter("serving.interactive.fallbacks").inc()

        def done(state: str = "fallback") -> None:
            self.sched.tenants.finished(tenant, state)
        return done

    # -- worker --------------------------------------------------------------

    def _run(self) -> None:
        while True:
            grp = self.collector.pop_due()
            if grp is None:
                return
            try:
                self._execute(grp)
            except Exception as e:
                # nothing may kill the lane's worker: answer every member
                # with the error and keep serving
                for r in grp.members:
                    if not r._done.is_set():
                        r.finish(error=e)

    def _execute(self, grp) -> None:
        sched = self.sched
        members = grp.members
        t_exec0 = time.time()
        for r in members:
            r.wait_ms = (t_exec0 - r.submitted_at) * 1e3
        batch_id = f"traverse-{next(_batch_seq)}"
        trace = None
        if sched.tracer.enabled:
            trace = sched.tracer.start(batch_id, "interactive",
                                       kind=grp.key[0], k=len(members))
            sched.tracer.event(batch_id, "fuse", parent=trace,
                               k=len(members),
                               window_ms=round(
                                   max(r.wait_ms for r in members), 3))
        w = sched.profiler.window() if sched.profiler is not None \
            else None
        err = None
        dispatched = False
        try:
            if isinstance(members[0].plan, PPRPlan):
                dispatched = self._run_ppr(members, batch_id)
            else:
                dispatched = self._run_traverse(members, batch_id)
        except Exception as e:
            err = e
            raise
        finally:
            wall = time.time() - t_exec0
            if err is None and dispatched:
                # executed device runs only: a group that fell back, died
                # or had no resolvable member is no fusion evidence
                self._metrics.counter("serving.interactive.batches").inc()
                self._metrics.histogram("serving.interactive.fuse_k") \
                    .update(float(len(members)))
            share = wall / len(members)
            for r in members:
                sched.tenants.device_seconds(r.tenant, share)
            if trace is not None:
                if w is not None:
                    cost = w.close()
                    w = None
                    if cost["calls"]:
                        sched.tracer.event(
                            batch_id, "device_cost", parent=trace,
                            k=len(members),
                            kernel_calls=cost["calls"],
                            compiles=cost["compiles"],
                            exec_ms=round(cost["exec_s"] * 1e3, 3),
                            h2d_bytes=cost["h2d_bytes"],
                            d2h_bytes=cost["d2h_bytes"])
                sched.tracer.end(trace,
                                 wall_ms=round(wall * 1e3, 3),
                                 **({"error": type(err).__name__}
                                    if err is not None else {}))
            if w is not None:
                w.close()
            if sched.recorder is not None:
                sched.recorder.metric_delta()

    # -- traversal groups ----------------------------------------------------

    def _run_traverse(self, members: list, batch_id: str) -> bool:
        sched = self.sched
        plan0: TraversalPlan = members[0].plan
        direction = plan0.direction
        labels = list(plan0.labels) if plan0.labels else None
        lease = sched.pool.acquire(labels=labels,
                                   directed=direction
                                   is not Direction.BOTH)
        with lease as snap:
            overlay = lease.overlay
            if overlay is None:
                overlay = getattr(snap, "_live_overlay", None)
            if overlay is not None and overlay.empty:
                overlay = None
            if overlay is not None and direction is not Direction.BOTH:
                # the overlay's slot bitmap and add orientation belong to
                # the symmetrized live base
                raise FallbackToInterpreter(
                    "directed chain over a live overlay: the overlay "
                    "seam serves the symmetrized (both) orientation")
            if overlay is not None and plan0.hop_labels is not None:
                # per-level label masks ride the tombstone seam, and the
                # overlay's adds carry labels the slot mask cannot filter
                raise FallbackToInterpreter(
                    "mixed-label chain over a live overlay: compact "
                    "the overlay first")
            epoch_info = lease.epoch_info \
                or {"epoch": getattr(snap, "epoch", 0)}
            # seeds: V(ids) skips unknown vertices, like the
            # interpreter's tx.vertex(i) None-filter
            runnable: list = []
            seeds: list = []
            for r in members:
                ds = []
                for vid in r.plan.start_ids:
                    try:
                        ds.append(snap.dense_of(int(vid)))
                    except (KeyError, TypeError, ValueError):
                        pass
                if ds:
                    runnable.append(r)
                    seeds.append(ds)
                else:
                    r.finish(result=self._empty_result(
                        r.plan, batch_id, len(members), epoch_info))
            if not runnable:
                return False
            # HBM admission FIRST, build second (the heavy queue's
            # order): the layout this run reads is sized on the host (the
            # forward image for in_/both, the REVERSED layout for out(),
            # its q_total an O(n) sum over in-degrees) and reserved
            # before any device bytes move. An AdmissionError fails the
            # group; the finally unpins exactly what was reserved
            if direction is Direction.OUT:
                key = ("interactive-rev", id(snap))
                deg_in = np.diff(snap.indptr_in)
                q_rev = int((-(-deg_in // 8)).sum()) + 1
                nbytes = chunked_csr_bytes(snap.n, q_rev)
                handle = (snap, "_hybrid_csr_rev_by_device")
            else:
                key = id(snap)
                nbytes = snapshot_csr_bytes(snap)
                handle = snap
            try:
                sched.ledger.reserve(key, nbytes)
            except AdmissionError as e:
                for r in runnable:
                    r.finish(error=e)
                return False
            sched._evictable.setdefault(key, handle)
            g = reversed_chunked_csr(snap, self.device) \
                if direction is Direction.OUT \
                else build_chunked_csr(snap, self.device)
            # mixed-label chain: a slot bitmap a distinct hop label set
            # over the union-label lease, passed as per-level masks
            level_masks = None
            if plan0.hop_labels is not None:
                level_masks = hop_label_masks(snap, plan0, direction,
                                              self.device)
            # per-tenant HBM accounting, as in the heavy queue: the
            # image's bytes are held against each member's tenant while
            # the run is in flight, then turned into byte-seconds
            share = nbytes / len(runnable)
            for r in runnable:
                sched.tenants.hold_hbm(r.tenant, share)
            t0 = time.time()
            try:
                self._sweep(runnable, seeds, g, overlay, snap, batch_id,
                            len(members), epoch_info,
                            level_masks=level_masks)
            finally:
                wall = time.time() - t0
                for r in runnable:
                    sched.tenants.drop_hbm(r.tenant, share)
                    sched.tenants.hbm_byte_seconds(r.tenant,
                                                   share * wall)
                sched.ledger.unpin(key)
            return True

    def _sweep(self, runnable, seeds, g, overlay, snap, batch_id,
               fused_k, epoch_info, level_masks=None) -> None:
        n = g["n"]
        dev = g["dstT"].device
        depths = [r.plan.depth for r in runnable]
        D = max(depths)
        K = len(runnable)
        # pad the batch to its power-of-two bucket, as the JAX lane does
        # (there to reuse a compiled shape); pad rows have depth 0, so
        # the level-1 keep mask retires them before any sweep
        Kp = 1 << max(K - 1, 1).bit_length() if K > 1 else 1
        depths_p = depths + [0] * (Kp - K)

        def on_level(level, nf):
            keep = np.asarray([level <= d for d in depths_p])
            return keep if not keep.all() else None

        t0 = time.time()
        if all(len(ds) == 1 for ds in seeds):
            # the common point-query shape (one start vertex): seeded on
            # the device through the sources path, no [Kp, n] upload
            srcs = [ds[0] for ds in seeds] + [0] * (Kp - K)
            dist, _levels, _completed = frontier_bfs_batched(
                g, srcs, max_levels=D + 1, start_level=1,
                on_level=on_level, overlay=overlay, mode="hops",
                level_masks=level_masks, return_device=True, device=dev)
        else:
            # multi-start members (V(id1, id2, ...)): the dense init
            init = np.zeros((Kp, n), np.int32)
            for k, ds in enumerate(seeds):
                init[k, ds] = 1
            dist, _levels, _completed = frontier_bfs_batched(
                g, [0] * Kp, max_levels=D + 1, start_level=1,
                init_dist=init, on_level=on_level, overlay=overlay,
                mode="hops", level_masks=level_masks,
                return_device=True, device=dev)
        # the hop sets stay on the device: one [Kp] size readback, then a
        # compacted index list per id/values member, never the O(n) row
        want = torch.tensor(depths_p, dtype=torch.int32, device=dev) + 1
        masks = dist == want[:, None]
        sizes = masks.sum(dim=1, dtype=torch.int32).cpu().numpy()
        devprof.count_d2h("interactive.sizes", int(sizes.nbytes))
        exec_ms = (time.time() - t0) * 1e3
        for k, r in enumerate(runnable):
            plan: TraversalPlan = r.plan
            count = int(sizes[k])
            try:
                if plan.terminal == "count":
                    result = count
                elif count == 0:
                    result = []
                else:
                    cap = min(next_pow2(count), next_pow2(n))
                    _c, ids_dev = compact_ids(masks[k], cap, n)
                    hopset = ids_dev[:count].cpu().numpy()
                    devprof.count_d2h("interactive.hopset",
                                      int(hopset.nbytes))
                    result = self._terminal(plan, snap, hopset)
            except FallbackToInterpreter as e:
                r.finish(error=e)
                continue
            r.finish(result={"result": result, "batch": batch_id,
                             "fused_k": fused_k, "hops": plan.depth,
                             "wait_ms": round(r.wait_ms, 3),
                             "exec_ms": round(exec_ms, 3),
                             "epoch": epoch_info})

    def _empty_result(self, plan, batch_id, fused_k, epoch_info) -> dict:
        empty = 0 if plan.terminal == "count" else []
        return {"result": empty, "batch": batch_id, "fused_k": fused_k,
                "hops": plan.depth, "wait_ms": 0.0, "exec_ms": 0.0,
                "epoch": epoch_info}

    def _terminal(self, plan: TraversalPlan, snap, hopset):
        if plan.terminal == "count":
            return int(len(hopset))
        if plan.terminal == "id":
            return [int(snap.vertex_ids[i]) for i in hopset]
        vals, present = self._vertex_column(snap, plan.terminal[1])
        return [vals[i] for i in hopset if present[i]]

    def _vertex_column(self, snap, key: str):
        """The dense property column of a values() terminal: the
        snapshot's ``vertex_values``, attached from the pool's graph when
        missing; FallbackToInterpreter when the snapshot cannot answer
        faithfully (not bound to a graph, stale, or a key that is not
        SINGLE-cardinality)."""
        got = snap.vertex_values.get(key)
        if got is not None:
            return got
        graph = self.sched.pool.graph
        if graph is None or getattr(snap, "_graph", None) is None:
            raise FallbackToInterpreter(
                f"snapshot carries no {key!r} column and is not bound "
                "to a graph to build one from")
        if snap.stale:
            raise FallbackToInterpreter(
                f"snapshot went stale before the {key!r} column was "
                "attached")
        try:
            snap.attach_vertex_values(graph, [key])
        except ValueError as e:
            raise FallbackToInterpreter(str(e)) from e
        return snap.vertex_values[key]

    # -- personalized PageRank groups ---------------------------------------

    def _run_ppr(self, members: list, batch_id: str) -> bool:
        sched = self.sched
        plan0: PPRPlan = members[0].plan
        labels = list(plan0.labels) if plan0.labels else None
        # dense window sweeps have no overlay seam: compacted=True folds
        # the live overlay first
        lease = sched.pool.acquire(labels=labels, directed=plan0.directed,
                                   compacted=True)
        with lease as snap:
            epoch_info = lease.epoch_info \
                or {"epoch": getattr(snap, "epoch", 0)}
            runnable, sources = [], []
            for r in members:
                try:
                    sources.append(snap.dense_of(int(r.plan.source)))
                    runnable.append(r)
                except (KeyError, TypeError, ValueError) as e:
                    r.finish(error=ValueError(
                        f"unknown ppr source {r.plan.source!r}: {e}"))
            if not runnable:
                return False
            key = id(snap)
            nbytes = snapshot_csr_bytes(snap)
            try:
                sched.ledger.reserve(key, nbytes)
            except AdmissionError as e:
                for r in runnable:
                    r.finish(error=e)
                return False
            sched._evictable.setdefault(key, snap)
            share = nbytes / len(runnable)
            for r in runnable:
                sched.tenants.hold_hbm(r.tenant, share)
            t0 = time.time()
            try:
                ranks, iters = pagerank_personalized_batched(
                    snap, sources, iterations=plan0.iterations,
                    damping=plan0.damping, overlay=lease.overlay,
                    device=self.device)
                exec_ms = (time.time() - t0) * 1e3
            finally:
                wall = time.time() - t0
                for r in runnable:
                    sched.tenants.drop_hbm(r.tenant, share)
                    sched.tenants.hbm_byte_seconds(r.tenant, share * wall)
                sched.ledger.unpin(key)
            self._metrics.counter("serving.interactive.ppr_users") \
                .inc(len(runnable))
            for s, r in enumerate(runnable):
                plan: PPRPlan = r.plan
                recs = top_k_per_user(
                    ranks[s:s + 1], snap.vertex_ids, k=plan.top_k,
                    exclude=[None if plan.include_source
                             else sources[s]])[0]
                r.finish(result={
                    "result": [[vid, rank] for vid, rank in recs],
                    "batch": batch_id, "fused_k": len(members),
                    "iterations": int(iters),
                    "wait_ms": round(r.wait_ms, 3),
                    "exec_ms": round(exec_ms, 3),
                    "epoch": epoch_info})
            return True
