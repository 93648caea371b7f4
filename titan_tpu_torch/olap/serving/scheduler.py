"""Concurrent job scheduler: priority queue + admission + batch worker
(the port's copy of ``titan_tpu/olap/serving/scheduler.py``; it runs
every job on its ``device``, CUDA unless ``device="cpu"`` is passed).

The control half of the serving layer (reference seam: gremlin-server's
request executor feeding FulgoraGraphComputer — rebuilt as an explicit
queue because a graph engine on an accelerator is throughput-bound on
device residency, not thread-bound):

* submit() enqueues a JobSpec by (priority desc, deadline asc, FIFO);
* the single worker drains batches: it pops the head job, gathers up to
  ``max_batch - 1`` more QUEUED jobs with the same batch key
  (same-snapshot BFS today), leases the snapshot from the epoch-aware
  pool, admits the group against the HBM ledger (the graph image is
  pinned for the run, largest-first eviction of idle images), and hands
  the group to the Batcher;
* cancellation (queued: immediate; running: level-boundary early-exit),
  deadlines (EXPIRED before start) and timeouts are job-level paths, so
  one stuck caller never wedges the queue;
* recovery (olap/recovery, ``checkpoint_dir=``): a RUNNING job that
  dies retryably goes RETRYING (Job.fail), requeues after its
  exponential backoff gate (``Job.not_before`` — deferred entries stay
  heap-resident and are skipped until due), and its next attempt
  resumes from the newest valid checkpoint; retries exhausted → FAILED.

Metrics (utils/metrics.MetricManager):
  serving.jobs.{submitted,completed,failed,cancelled,expired,timeout}
  serving.jobs.rejected          (submits refused by admission — closed
                                  scheduler / unknown kind; NOT counted
                                  as submitted)
  serving.queue.depth            (gauge-flagged counter, inc on enqueue
                                  / dec on pop; labeled children break
                                  the depth out by priority class so
                                  head-of-line blocking is visible)
  serving.job.latency_ms         (histogram: submit → terminal, p50/p95)
  serving.job.queue_ms           (histogram: submit → start)
  serving.batch.occupancy        (histogram: K per executed batch)
  serving.recovery.checkpoints / .checkpoint_bytes / .checkpoint_ms
  serving.recovery.invalid_checkpoints (digest-rejected at resume)
  serving.recovery.resumes / .rounds_replayed
  serving.recovery.retries / .retries_exhausted
  serving.tenant.{rejected,throttled}  (quota admissions, by tenant)
  serving.hbm.{resident_bytes,pinned_bytes} + serving.pool.snapshots
                                 (callback gauges over the ledger/pool)

Device-cost observability (titan_tpu_torch/obs/devprof + flightrec): the
scheduler installs a process-wide DeviceCostProfiler by default
(``profiling=False`` / TITAN_TPU_PROFILING=0 removes it) — kernel
builds, per-kernel device time (CUDA events, resolved after each batch)
and H2D/D2H bytes land on the ``device.*`` families, and each executed
batch's device cost is stitched into its jobs' traces as a
``device_cost`` span (split over K, like the device-seconds
accounting). ``flight_dir=`` (or TITAN_TPU_FLIGHT_DIR) attaches a
FlightRecorder: a bounded ring journals spans / device events /
counter deltas, and a job that entered execution and ended FAILED /
TIMEOUT / CANCELLED — or its first RETRYING transition — writes a
self-contained postmortem bundle (``job.dump_path``, on-demand via
``dump_debug``).

Tenancy (olap/serving/tenants): every job belongs to a tenant
(``spec.tenant``, falling back to "default"); the per-job counters and
latency/queue histograms write through {kind, tenant}-labeled children
that sum exactly into the unlabeled parents, and the scheduler accounts
queue-ms / device-seconds (batch wall split across the K fused jobs) /
HBM byte-seconds / replayed-rounds per tenant (``tenant_stats()`` →
``GET /tenants``). Per-tenant quotas check at submit() behind
``enforce_quotas`` (default OFF: violations are admitted but counted as
throttled — observable-first); ``slos=[obs.slo.SLO(...)]`` attaches the
SLO engine (``slo_report()`` → ``GET /slo``, burn-rate gauges).

Autotuning (olap/serving/autotune, ROADMAP #4): a ``Controller`` owned
by this scheduler reads the registries above on a fixed tick and
journals bounded knob decisions (batch K, tenant quota scaling,
compaction triggers, checkpoint cadence). Shadow by default —
``autotune="enforce"`` / TITAN_TPU_AUTOTUNE=enforce lets them move the
knobs; ``autotune="off"`` removes the plane. ``GET /controller`` serves
the journal; ``controller.*`` metric families export the decision flow.

Tracing (titan_tpu_torch/obs): one trace per job (trace id ==
job id) — ``submit`` / ``queue`` / per-attempt ``attempt`` spans open
here; ``fuse`` / ``run`` / per-round ``round`` / ``checkpoint`` spans
in the batcher and recovery hooks; the terminal state stamps the root.
``GET /trace?job=<id>`` renders the tree; ``tracing=False`` (or
TITAN_TPU_TRACING=0) removes the whole plane.

The worker's time (obs/devprof host stages, with a profiler installed):
every instant of the worker thread lies in one of four places, read
from ``kernel_stats()`` by key. ``serving.wait``: blocked on the queue's
condition with nothing runnable (both waits of the loop).
``serving.dispatch``: the worker's own work outside the model call,
entered more than once a batch: the autotune tick and the pop; the
batch's start (queue histograms, attempt spans, controller stitching),
the lease, the ledger reservation and the tenant holds; the batcher's
source resolution, fuse records and placement until its ``run`` spans
open; after the call, the tenant drops, attribution, unpin, the
profile window's close and the recorder; then each job's terminal
metrics or requeue. The batcher's ``run`` spans. ``serving.result``:
the batcher's result assembly, once a batch (for a BFS batch the K
rows' results and completions after the run spans close; for a
``dense`` job its outputs and completion, inside its run span, which
closes in ``Batcher.run_single``'s ``finally``). A host delegation
(``callable``) runs its function outside all four. No span and no
metric family comes of them.

Threads: the worker launches the kernels on the device's current stream,
the same stream the caller's own work uses, so nothing here creates a
stream; ``start()`` loads the kernel libraries on the caller's thread
before the worker exists, and ``close()`` joins the worker before it
returns, so the caller may free the snapshot afterwards.

The interactive point-query lane (``interactive()``,
olap/serving/interactive) is created on first use and shares this
scheduler's pool, ledger, tenants, tracer and profiler.

Over a graph (``graph=``) the pool builds and refreshes one snapshot per
job's labels, edge keys and orientation; a snapshot it discards leaves
the HBM ledger (``_forget_snapshot``). ``live=`` attaches a live plane
(``olap/live/plane.py``): jobs of its key lease (snapshot, overlay view)
pairs, the plane borrows this scheduler's ledger and tracer, and
``close()`` closes it; the plane must serve on this scheduler's device.

``mesh=`` (a ``parallel.mesh.LocalMesh``): batched BFS cohorts run over
the mesh's devices (``Batcher.would_mesh``; ``parallel/partition.
place_batched_csr``), and the ledger, which models one device, charges
them each device's share (``hbm.meshed_snapshot_csr_bytes``). ``device``
must be the mesh's first device (``ValueError`` otherwise): every other
kind and the interactive lane run there.
"""

from __future__ import annotations

import heapq
import itertools
import os
import threading
import time
from typing import Optional

from titan_tpu_torch.device import cache_key, resolve_device
from titan_tpu_torch.obs import devprof
from titan_tpu_torch.obs.flightrec import FlightRecorder
from titan_tpu_torch.obs.tracing import TraceHandle, Tracer
from titan_tpu_torch.olap.api import JobSpec
from titan_tpu_torch.olap.serving.batcher import Batcher, batch_key
from titan_tpu_torch.olap.serving.hbm import (AdmissionError, HBMLedger,
                                              meshed_snapshot_csr_bytes,
                                              snapshot_csr_bytes)
from titan_tpu_torch.olap.serving.jobs import Job, JobState
from titan_tpu_torch.olap.serving.pool import SnapshotPool
from titan_tpu_torch.olap.serving.tenants import (QuotaExceeded,
                                            TenantAccounting,
                                            effective_tenant)
from titan_tpu_torch.utils.metrics import MetricManager

#: job kinds that execute against a pooled snapshot (everything except
#: host 'callable' delegations)
_SNAPSHOT_KINDS = ("bfs", "sssp", "pagerank", "wcc", "dense")

_KNOWN_KINDS = _SNAPSHOT_KINDS + ("callable",)


class JobScheduler:
    """One queue + one worker over one graph (or fixed snapshot)."""

    def __init__(self, graph=None, snapshot=None, *, max_batch: int = 16,
                 mesh=None,
                 hbm_budget_bytes: Optional[float] = None,
                 metrics: Optional[MetricManager] = None,
                 autostart: bool = True,
                 checkpoint_dir: Optional[str] = None,
                 live=None, tracer: Optional[Tracer] = None,
                 tracing: Optional[bool] = None,
                 quotas: Optional[dict] = None,
                 enforce_quotas: bool = False,
                 slos=None, slo_clock=None,
                 profiling: Optional[bool] = None,
                 profiler=None,
                 flight_dir: Optional[str] = None,
                 flight_capacity: int = 4096,
                 interactive_window_s: Optional[float] = None,
                 interactive_max_fuse: Optional[int] = None,
                 interactive_max_depth: Optional[int] = None,
                 autotune: Optional[str] = None,
                 autotune_tick_s: Optional[float] = None,
                 autotune_clock=None,
                 autotune_params: Optional[dict] = None,
                 device=None):
        # the device every job runs on; None means CUDA and raises
        # without a card
        self.device = resolve_device(device)
        if mesh is not None and cache_key(mesh.devices[0]) \
                != cache_key(self.device):
            # never move unmeshed work off the mesh silently
            raise ValueError(f"the scheduler runs on {self.device}, the "
                             f"mesh's first device is {mesh.devices[0]}; "
                             "pass device=mesh.devices[0]")
        if live is not None and cache_key(live.device) \
                != cache_key(self.device):
            # never move a plane's work to another device silently
            raise ValueError(f"the live plane serves on {live.device}, "
                             f"the scheduler on {self.device}")
        # observability plane (titan_tpu/obs): one tracer per scheduler,
        # one trace per job (trace id == job id) — submit/queue/attempt
        # spans here, fuse/run/round/checkpoint spans in the batcher &
        # recovery hooks, all host-side. ``tracing=False`` (or env
        # TITAN_TPU_TRACING=0) removes it wholesale: jobs carry no
        # TraceHandle and every hook is a single None check.
        if tracer is None:
            if tracing is None:
                tracing = os.environ.get("TITAN_TPU_TRACING", "1") \
                    .lower() not in ("0", "false", "off")
            tracer = Tracer(enabled=tracing)
        self.tracer = tracer
        self._metrics = metrics or MetricManager.instance()
        # flight recorder (obs/flightrec): only exists when a dump
        # directory is configured — no ring, no taps, no files without
        # one. The tracer tap journals every completed span into the
        # bounded ring (round-mass tuples ride in round-span attrs)
        self.recorder = None
        if flight_dir is None:
            flight_dir = os.environ.get("TITAN_TPU_FLIGHT_DIR") or None
        if flight_dir:
            self.recorder = FlightRecorder(flight_dir,
                                           capacity=flight_capacity,
                                           metrics=self._metrics)
            self.tracer.tap = self.recorder.span_tap
        # device-cost profiler (obs/devprof): process-wide seams in the
        # kernel wrappers and the engine's superstep — builds, per-kernel
        # device time, H2D/D2H bytes as device.* metric families;
        # default ON, one flag removes it
        self.profiler = None
        self._own_profiler = False
        if profiler is not None:
            self.profiler = profiler
        else:
            if profiling is None:
                profiling = os.environ.get(
                    "TITAN_TPU_PROFILING", "1").lower() \
                    not in ("0", "false", "off")
            if profiling:
                self.profiler = devprof.DeviceCostProfiler(
                    metrics=self._metrics, recorder=self.recorder)
                self._own_profiler = True
        if self._own_profiler:
            self.profiler.install()
        # live plane (olap/live): jobs lease (snapshot, overlay) pairs
        # at a consistent epoch instead of refresh/rebuild churn; the
        # scheduler OWNS the plane's lifecycle once attached (close()
        # closes it) and lends it the HBM ledger so overlay growth is
        # admission-controlled
        self.live = live
        self.pool = SnapshotPool(graph, snapshot, live=live)
        # retired and closed snapshots must not stay ledger-resident
        self.pool.on_close = self._forget_snapshot
        # the evictable map must exist BEFORE the ledger (whose
        # on_evict callback reads it) and before the live plane's
        # hooks: the plane's pump thread is already running and can
        # fire a device-merged compaction mid-__init__
        self._evictable: dict = {}    # ledger key -> snapshot (cache drop)
        self.ledger = HBMLedger(hbm_budget_bytes, on_evict=self._evict,
                                device=self.device)
        if live is not None and live._ledger is None:
            live._ledger = self.ledger
        if live is not None and getattr(live, "_tracer", None) is None:
            # the plane records apply/compaction epochs under the
            # reserved "live" trace id (GET /trace?job=live)
            live._tracer = self.tracer
        if live is not None:
            # device-merged epochs arrive ledger-resident with their
            # CSR pre-attached (no upload); register them in the
            # eviction map so an HBM eviction of the unpinned epoch
            # actually drops the device arrays
            live._on_resident = (
                lambda snap: self._evictable.setdefault(id(snap), snap))
        # mesh-aware batch placement: with a multi-device mesh, batched
        # BFS cohorts split their vertices over the mesh's devices
        # (parallel/partition.place_batched_csr); the ledger (one
        # device's budget) then charges each device's share
        # (hbm.meshed_snapshot_csr_bytes)
        self.mesh = mesh
        self.batcher = Batcher(max_batch=max_batch, mesh=mesh,
                               device=self.device)
        self.max_batch = max_batch
        # (self._metrics was bound before the recorder/profiler above)
        # tenancy plane (olap/serving/tenants): authoritative per-tenant
        # attribution behind GET /tenants; quotas check at submit()
        # behind the enforce flag (default OFF = shadow mode: violations
        # admitted but counted throttled)
        self.tenants = TenantAccounting()
        self.quotas = dict(quotas or {})
        self.enforce_quotas = bool(enforce_quotas)
        # first-class gauges (utils/metrics.Gauge): HBM residency and
        # pool size as live callback views. queue depth stays a counter
        # (its counter_value contract predates gauges) flagged
        # bidirectional so the Prometheus exposition types it gauge.
        # The (gauge, fn) pairs are kept so close() can neutralize the
        # callbacks: the registry may be process-global, and a closed
        # scheduler's closures would otherwise pin its pool/ledger
        # forever and keep scraping dead residency numbers
        self._metrics.counter("serving.queue.depth", gauge=True)
        self._gauges = []
        for name, fn in (
                ("serving.hbm.resident_bytes",
                 self.ledger.resident_bytes),
                ("serving.hbm.pinned_bytes", self.ledger.pinned_bytes),
                ("serving.pool.snapshots",
                 lambda: self.pool.stats()["snapshots"])):
            self._gauges.append((self._metrics.gauge(name, fn), fn))
        # SLO engine (obs/slo): declarative objectives over the labeled
        # children this scheduler writes; burn rates export as gauges
        self.slo = None
        if slos:
            from titan_tpu_torch.obs.slo import SLOEngine
            self.slo = SLOEngine(self._metrics, slos,
                                 clock=slo_clock)
            self.slo.register_gauges()
        # closed-loop autotuning (olap/serving/autotune, ROADMAP #4):
        # the controller reads its signals off THIS scheduler's
        # registries on a fixed tick (driven from the worker loop) and
        # journals bounded, hysteresis-guarded knob decisions. Shadow
        # mode is the default — decisions are computed and journaled
        # but nothing moves; autotune="enforce" (or
        # TITAN_TPU_AUTOTUNE=enforce) lets them drive batch K, tenant
        # quota scaling, compaction triggers and checkpoint cadence.
        # autotune="off" removes the plane (no controller.* metrics).
        self.controller = None
        self._ctl_stitch_seq = 0
        if autotune is None:
            autotune = os.environ.get("TITAN_TPU_AUTOTUNE")
        from titan_tpu_torch.olap.serving.autotune import resolve_mode
        mode = resolve_mode(autotune)
        if mode != "off":
            from titan_tpu_torch.olap.serving.autotune import Controller
            self.controller = Controller(
                self, mode=mode, tick_s=autotune_tick_s,
                clock=autotune_clock, **(autotune_params or {}))
        # recovery plane: one store for every job's checkpoints, keyed
        # by a per-scheduler nonce + job id (job ids restart at job-1
        # per process while the store persists on disk — a restarted
        # server must never resume an OLD process's checkpoint for an
        # unrelated job); None disables capture, retries restart clean
        self.ckpt_store = None
        if checkpoint_dir is not None:
            import uuid

            from titan_tpu_torch.olap.recovery import CheckpointStore
            self.ckpt_store = CheckpointStore(checkpoint_dir,
                                              metrics=self._metrics)
            self._ckpt_ns = uuid.uuid4().hex[:12]
        # the interactive lane (olap/serving/interactive), made on the
        # first point query; the fuse window, occupancy and depth ceiling
        # are scheduler configuration
        self._interactive = None
        self._interactive_cfg = {
            k: v for k, v in (("window_s", interactive_window_s),
                              ("max_fuse", interactive_max_fuse),
                              ("max_depth", interactive_max_depth))
            if v is not None}
        self._jobs: dict[str, Job] = {}
        self._heap: list = []
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._stop = False
        self._running_batch = 0
        self._worker: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._stop

    def start(self) -> "JobScheduler":
        if self.device.type == "cuda":
            # build and bind the three kernel libraries here, on the
            # caller's thread, before the worker's first launch
            from titan_tpu_torch.ops import frontier, seg_scan
            frontier.kernel_library()
            frontier.exhaust_library()
            seg_scan.kernel_library()
        if self._worker is None or not self._worker.is_alive():
            self._stop = False
            self._worker = threading.Thread(target=self._run,
                                            name="serving-scheduler",
                                            daemon=True)
            self._worker.start()
        return self

    def interactive(self):
        """The scheduler's interactive point-query lane
        (olap/serving/interactive.InteractiveLane), created on first use
        under the scheduler's lock and refused once it is closed. On the
        card the lane's two kernel libraries are built here, on the
        caller's thread: a first build in the lane's worker would stall
        the first query by the compile."""
        with self._cv:
            if self._stop:
                raise RuntimeError("scheduler is closed")
            if self._interactive is None or self._interactive.closed:
                from titan_tpu_torch.olap.serving.interactive import \
                    InteractiveLane
                if self.device.type == "cuda":
                    from titan_tpu_torch.ops import frontier
                    frontier.kernel_library()
                    frontier.exhaust_library()
                self._interactive = InteractiveLane(
                    self, **self._interactive_cfg)
            return self._interactive

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker and join it, fail what is still queued and
        release the pool. A worker still inside a batch after
        ``timeout`` seconds raises RuntimeError: its kernels may still
        read the snapshot's device tensors."""
        with self._cv:
            # under the lock: interactive() creates the lane under it and
            # refuses once _stop is set, so no lane escapes the close
            self._stop = True
            lane = self._interactive
            self._cv.notify_all()
        if lane is not None:
            lane.close()
        if self._worker is not None:
            self._worker.join(timeout)
            if self._worker.is_alive():
                raise RuntimeError(
                    f"scheduler worker still running after {timeout} s; "
                    "its batch may still use the snapshot")
        # queued jobs fail loudly rather than hang their waiters
        # (permanent: a closing scheduler must not re-enter RETRYING)
        for job in self.jobs():
            if not job.state.terminal:
                job.fail("scheduler closed", permanent=True)
                self._finalize_metrics(job)
        self.pool.close()
        if self.live is not None:
            self.live.close()
        # detach OUR gauge callbacks (identity-checked: a successor
        # scheduler that already re-registered over the same names
        # must not be clobbered) — the gauges read 0.0 afterwards
        for g, fn in self._gauges:
            if g.fn is fn:
                g.fn = None
                g.set(0.0)
        if self.slo is not None:
            self.slo.detach_gauges()
        if self.controller is not None:
            self.controller.detach_gauges()
        # detach OUR process-wide profiler (a caller-provided one stays
        # the caller's to uninstall)
        if self._own_profiler and self.profiler is not None:
            self.profiler.uninstall()

    #: the snapshot's device caches the ledger charges: the chunked CSR
    #: (models/bfs_hybrid.build_chunked_csr), the engine's edge arrays
    #: (olap/engine.device_graph) and the interactive lane's label masks
    #: (olap/serving/interactive/compile.hop_label_masks), each a dict
    #: by device, and the mesh-placed blocks
    #: (parallel/partition.place_batched_csr), a dict by mesh
    _DEVICE_CACHES = ("_hybrid_csr_by_device", "_device_graphs",
                      "_hop_label_masks_by_device", "_batched_csr_by_mesh")

    def _evict(self, key) -> None:
        """Device-memory eviction: drop the snapshot's cached device
        tensors (the memory frees when the last reference dies; a later
        job rebuilds and uploads them). An ``(obj, attr)`` entry drops
        that attribute and the lane's label masks instead: the
        interactive lane's reversed layout registers itself this way."""
        handle = self._evictable.pop(key, None)
        if handle is None:
            return
        if isinstance(handle, tuple):
            snap, attrs = handle[0], (handle[1],
                                      "_hop_label_masks_by_device")
        else:
            snap, attrs = handle, self._DEVICE_CACHES
        for attr in attrs:
            if hasattr(snap, attr):
                delattr(snap, attr)

    def _forget_snapshot(self, snap) -> None:
        """Pool close hook: a retired or rebuilt snapshot leaves the HBM
        ledger and the evictable map, the interactive lane's reversed
        layout on it included, instead of counting as resident."""
        key = id(snap)
        self._evictable.pop(key, None)
        self.ledger.release(key)
        rev_key = ("interactive-rev", key)
        self._evictable.pop(rev_key, None)
        self.ledger.release(rev_key)

    # -- submission surface --------------------------------------------------

    def _job_labels(self, job: Job) -> dict:
        """The {kind, tenant} label set the per-job metric children
        carry — bounded: kind is validated at admission, tenant
        cardinality is capped by the registry's MAX_CHILDREN guard."""
        return {"kind": job.spec.kind, "tenant": job.tenant}

    def submit(self, spec: JobSpec) -> Job:
        tenant = effective_tenant(getattr(spec, "tenant", None))
        # rejected submits must NOT count as submitted (the counter
        # moves only after admission): unknown kinds and closed-
        # scheduler refusals are serving.jobs.rejected instead
        if spec.kind not in _KNOWN_KINDS:
            self._metrics.counter(
                "serving.jobs.rejected",
                labels={"kind": "unknown", "tenant": tenant}).inc()
            raise ValueError(f"unknown job kind {spec.kind!r} "
                             f"(known: {', '.join(_KNOWN_KINDS)})")
        faults = spec.params.get("faults") \
            if isinstance(spec.params, dict) else None
        if faults is not None:
            from titan_tpu_torch.olap.recovery import FaultPlan
            if not isinstance(faults, FaultPlan):
                # an arbitrary wire value here would detonate inside
                # the fused batch's level callback and fail every
                # batchmate — reject it at admission instead
                self._metrics.counter(
                    "serving.jobs.rejected",
                    labels={"kind": spec.kind, "tenant": tenant}).inc()
                raise ValueError("params['faults'] must be a "
                                 "recovery.FaultPlan (test harness "
                                 "only, not wire-settable)")
        # tenant quota gate (olap/serving/tenants): check + reservation
        # are ONE atomic step (concurrent submits racing a max_in_flight
        # limit must not both read "below limit" and both admit).
        # Enforcement is flagged, default off — a violating submit in
        # shadow mode is admitted but counted, so admission control
        # lands observable-first. An ENFORCING autotune controller may
        # scale the configured quota down (tenant shedding) — the gate
        # checks the scaled limit, the journal explains why.
        quota = self.quotas.get(tenant)
        if self.controller is not None:
            quota = self.controller.scaled_quota(tenant, quota)
        why = self.tenants.admit(tenant, quota, self.enforce_quotas)
        if why is not None:
            if self.enforce_quotas:
                self._metrics.counter("serving.tenant.rejected",
                                      labels={"tenant": tenant}).inc()
                raise QuotaExceeded(f"tenant {tenant!r}: {why}")
            self._metrics.counter("serving.tenant.throttled",
                                  labels={"tenant": tenant}).inc()
        # from here the tenant holds an in-flight reservation: ANY
        # raise before the job is actually accepted (closed scheduler,
        # junk deadline type, recovery-plan construction, ...) must
        # back it out, or failed submits pin quota slots forever
        try:
            return self._submit_admitted(spec, faults)
        except BaseException:
            self.tenants.unadmit(tenant)
            raise

    def _submit_admitted(self, spec: JobSpec, faults) -> Job:
        """Post-quota-gate tail of ``submit``: the caller owns the
        tenant's admission reservation and backs it out if we raise."""
        job = Job(spec)
        if self.tracer.enabled:
            root = self.tracer.start(job.id, "job", kind=spec.kind,
                                     priority=spec.priority,
                                     tenant=job.tenant)
            job.trace = TraceHandle(self.tracer, job.id, root)
            job.trace.event("submit", parent=root)
        # checkpoint cadence: the spec's own setting wins; a retryable
        # job that did not pick one adopts the autotune controller's
        # measured-cost cadence when enforcement is on (hint() is 0
        # otherwise — shadow mode never changes capture behavior)
        every = spec.checkpoint_every
        if every <= 0 and spec.max_retries > 0 \
                and self.controller is not None:
            every = self.controller.checkpoint_every_hint()
        store = self.ckpt_store \
            if self.ckpt_store is not None \
            and (every > 0 or spec.idempotency_key) \
            else None
        if store is not None or faults is not None:
            from titan_tpu_torch.olap.recovery import JobRecovery
            # fleet failover: an idempotency key names the LOGICAL job
            # across processes, so its checkpoints bypass the
            # per-scheduler nonce namespace — a redispatch of the same
            # key on another replica finds them and resumes
            key = None
            if store is not None:
                key = f"idem-{spec.idempotency_key}" \
                    if spec.idempotency_key \
                    else f"{self._ckpt_ns}-{job.id}"
            job.recovery = JobRecovery(
                store, job, every=every, faults=faults,
                metrics=self._metrics, key=key)
        if spec.deadline is not None and time.time() > spec.deadline:
            # tenant admission was already reserved by tenants.admit
            self._metrics.counter(
                "serving.jobs.submitted",
                labels=self._job_labels(job)).inc()
            job.expire()
            self._finalize_metrics(job)
            with self._cv:
                self._jobs[job.id] = job
            return job
        with self._cv:
            if self._stop:
                self._metrics.counter(
                    "serving.jobs.rejected",
                    labels=self._job_labels(job)).inc()
                # the job was never admitted: drop its just-opened
                # trace (or rejected submits would pile never-ending
                # root spans into the tracer's LRU); the quota
                # reservation is backed out by submit()'s except
                self.tracer.discard(job.id)
                raise RuntimeError("scheduler is closed")
            self._metrics.counter(
                "serving.jobs.submitted",
                labels=self._job_labels(job)).inc()
            self._jobs[job.id] = job
            if job.trace is not None:
                job.trace.queue = job.trace.start(
                    "queue", parent=job.trace.root)
            self._push_locked(job)
        return job

    def _depth(self, job: Job, n: int) -> None:
        """Queue-depth move, labeled by the job's priority class — the
        child rolls up into the unlabeled total, and the per-priority
        breakout makes head-of-line blocking visible on /metrics."""
        self._metrics.counter(
            "serving.queue.depth",
            labels={"priority": str(job.spec.priority)}).inc(n)

    def _push_locked(self, job: Job) -> None:
        """Heap insert (priority desc, deadline asc, FIFO) + depth/
        notify — under the cv lock; shared by submit() and _requeue()
        so the ordering key has exactly one definition."""
        heapq.heappush(self._heap,
                       (-job.spec.priority,
                        job.spec.deadline
                        if job.spec.deadline is not None
                        else float("inf"),
                        next(self._seq), job))
        self._depth(job, 1)
        self._cv.notify()

    def get(self, job_id: str) -> Optional[Job]:
        with self._cv:
            return self._jobs.get(job_id)

    def cancel(self, job_id: str) -> bool:
        job = self.get(job_id)
        if job is None:
            return False
        # RETRYING cancels like QUEUED: immediately, off the worker path
        was_queued = job.state in (JobState.QUEUED, JobState.RETRYING)
        ok = job.cancel()
        if ok and was_queued and job.state is JobState.CANCELLED:
            self._finalize_metrics(job)
        return ok

    def jobs(self) -> list[Job]:
        with self._cv:
            return list(self._jobs.values())

    def live_stats(self) -> Optional[dict]:
        """The live plane's freshness/overlay/compaction stats
        (``GET /live``); None when no plane is attached."""
        return self.live.stats() if self.live is not None else None

    def tenant_stats(self) -> dict:
        """Per-tenant attribution + quota view (``GET /tenants``):
        the accounting rows (queue-ms, device-seconds, HBM
        byte-seconds, replayed rounds, in-flight, admissions) plus the
        configured quotas and the enforcement flag."""
        return {"enforce_quotas": self.enforce_quotas,
                "tenants": self.tenants.stats(),
                "quotas": {t: q.to_wire()
                           for t, q in sorted(self.quotas.items())}}

    def slo_report(self) -> Optional[dict]:
        """The SLO engine's full evaluation (``GET /slo``): per
        objective, the current SLI and the multi-window error-budget
        burn rates; None when no objectives are attached."""
        return self.slo.evaluate() if self.slo is not None else None

    def trace_summary(self, job_id: str) -> Optional[dict]:
        """Per-job trace digest (queue_ms / fuse_ms / device_ms /
        rounds) for the ``GET /jobs`` envelope; None when tracing is
        disabled or the trace was evicted."""
        from titan_tpu_torch.obs.tracing import trace_summary
        return trace_summary(self.tracer, job_id)

    # -- postmortems (obs/flightrec) ----------------------------------------

    def _dump_config(self) -> dict:
        """The scheduler's effective configuration for the bundle —
        enough to reproduce the serving posture without the process."""
        return {"max_batch": self.max_batch,
                "mesh_devices": int(self.mesh.size)
                if self.mesh is not None else None,
                "device": str(self.device),
                "hbm_budget_bytes": self.ledger.budget_bytes,
                "tracing": self.tracer.enabled,
                "profiling": self.profiler is not None,
                "checkpoints": self.ckpt_store is not None,
                "live": self.live is not None,
                "autotune": self.controller.mode
                if self.controller is not None else "off",
                "enforce_quotas": self.enforce_quotas,
                "quotas": {t: q.to_wire()
                           for t, q in sorted(self.quotas.items())}}

    def _dump(self, job: Optional[Job], reason: str) -> Optional[str]:
        """Write a postmortem bundle for ``job`` (or a whole-system
        snapshot when None); never raises into the worker path."""
        if self.recorder is None:
            return None
        try:
            path = self.recorder.dump(
                reason=reason,
                job=job.to_wire() if job is not None else None,
                span_tree=self.tracer.tree(job.id)
                if job is not None and self.tracer.enabled else None,
                state={"scheduler": self.stats(),
                       "ledger": {
                           "resident_bytes":
                               self.ledger.resident_bytes(),
                           "pinned_bytes": self.ledger.pinned_bytes(),
                           "budget_bytes": self.ledger.budget_bytes},
                       "pool": self.pool.stats(),
                       "live": self.live_stats(),
                       # the decision journal rides in every bundle:
                       # a postmortem must show what the controller
                       # was doing to the knobs beforehand
                       "controller": self.controller.state()
                       if self.controller is not None else None},
                config=self._dump_config(),
                profiler=self.profiler)
        except Exception:
            # dump.errors already counted by the recorder; a broken
            # dump directory must never take the worker down
            return None
        if job is not None:
            job.dump_path = path
        return path

    def dump_debug(self, job_id: Optional[str] = None,
                   reason: str = "manual") -> str:
        """On-demand postmortem (``POST /debug/dump``): dump the ring +
        state now, optionally anchored to a job. Raises ValueError for
        an unknown job id or when no flight recorder is attached."""
        if self.recorder is None:
            raise ValueError("flight recorder disabled — construct the "
                             "scheduler with flight_dir= (or set "
                             "TITAN_TPU_FLIGHT_DIR)")
        job = None
        if job_id is not None:
            job = self.get(job_id)
            if job is None:
                raise ValueError(f"unknown job {job_id!r}")
        path = self._dump(job, reason=reason)
        if path is None:
            raise RuntimeError("postmortem dump failed (see "
                               "flightrec.dump.errors)")
        return path

    def stats(self) -> dict:
        with self._cv:
            depth = sum(1 for *_x, j in self._heap
                        if j.state in (JobState.QUEUED,
                                       JobState.RETRYING))
            running = self._running_batch
            jobs = list(self._jobs.values())
        by_state: dict = {}
        for j in jobs:
            by_state[j.state.value] = by_state.get(j.state.value, 0) + 1
        return {"queue_depth": depth, "running_batch": running,
                "jobs_total": len(jobs), "by_state": by_state,
                "hbm_resident_bytes": self.ledger.resident_bytes(),
                **{f"pool_{k}": v for k, v in self.pool.stats().items()}}

    # -- worker --------------------------------------------------------------

    _STATE_COUNTER = {JobState.DONE: "completed",
                      JobState.FAILED: "failed",
                      JobState.TIMEOUT: "timeout",
                      JobState.CANCELLED: "cancelled",
                      JobState.EXPIRED: "expired"}

    def _finalize_metrics(self, job: Job) -> None:
        """Record a terminal job's state counter + latency sample,
        exactly once per job (cancel vs worker completion can race)."""
        if not job.state.terminal or not job.metered_once():
            return
        name = self._STATE_COUNTER[job.state]
        h = job.trace
        if h is not None:
            # close whatever is still open (a job cancelled while
            # queued never started; an expired one never ran) and stamp
            # the terminal state as the tree's last child
            if h.attempt is not None:
                h.end(h.attempt, state=job.state.value)
                h.attempt = None
            if h.queue is not None and h.queue.open:
                h.end(h.queue)
            h.event(job.state.value, parent=h.root)
            h.end(h.root, status=job.state.value,
                  **({"error": job.error} if job.error else {}))
        self._metrics.counter(f"serving.jobs.{name}",
                              labels=self._job_labels(job)).inc()
        # tenant attribution closes out here: the job leaves in-flight,
        # its terminal state lands in the per-tenant row, and any
        # recovery-plane replay it caused is charged to its tenant
        self.tenants.finished(job.tenant, name,
                              rounds_replayed=job.rounds_replayed)
        if job.retries_exhausted:
            self._metrics.counter(
                "serving.recovery.retries_exhausted").inc()
        if job.finished_at is not None and job.started_at is not None:
            # jobs that never entered execution (cancelled while
            # queued, expired at submit) record NO latency sample:
            # their ~0ms "latencies" would drag the p95 down and
            # dilute the SLO engine's latency SLI — a tenant flooding
            # expired jobs must not mask its real jobs' breaches
            self._metrics.histogram(
                "serving.job.latency_ms",
                labels=self._job_labels(job)).update(
                (job.finished_at - job.submitted_at) * 1e3)
        # postmortem (obs/flightrec): a job that ENTERED execution and
        # ended abnormally — FAILED, TIMEOUT, or a mid-flight kill —
        # writes its bundle now, AFTER the terminal span stamped above,
        # so the dump's span tree matches GET /trace exactly
        if self.recorder is not None and job.started_at is not None \
                and job.state in (JobState.FAILED, JobState.TIMEOUT,
                                  JobState.CANCELLED):
            self._dump(job, reason=job.state.value)

    def _pop_group(self) -> list[Job]:
        """Under the cv lock: pop the head runnable job + compatible
        batchmates; drop cancelled/expired entries on the way. RETRYING
        entries are runnable but gated by their backoff (``not_before``)
        — not-yet-due ones go back on the heap untouched."""
        group: list[Job] = []
        leftovers: list = []
        key = None
        while self._heap:
            entry = heapq.heappop(self._heap)
            job = entry[3]
            if job.state not in (JobState.QUEUED, JobState.RETRYING):
                self._depth(job, -1)
                continue       # cancelled while queued (already terminal)
            if job.not_before is not None and time.time() < job.not_before:
                leftovers.append(entry)    # backoff not elapsed
                continue
            if job.state is JobState.QUEUED and \
                    job.spec.deadline is not None and \
                    time.time() > job.spec.deadline:
                # start-deadline applies to the FIRST start only: a
                # RETRYING job already met it
                self._depth(job, -1)
                if job.expire():
                    self._finalize_metrics(job)
                continue
            if not group:
                group.append(job)
                self._depth(job, -1)
                key = batch_key(job.spec)
                if key is None:
                    break      # unbatchable head runs alone
                continue
            if batch_key(job.spec) == key and len(group) < self.max_batch:
                group.append(job)
                self._depth(job, -1)
                if len(group) >= self.max_batch:
                    break      # full batch: stop draining the heap
            else:
                leftovers.append(entry)
        for entry in leftovers:
            heapq.heappush(self._heap, entry)
        return group

    def _requeue(self, job: Job) -> None:
        """Put a RETRYING job back on the heap (its ``not_before``
        backoff gate keeps _pop_group from re-running it early). Under
        a closing scheduler the close() sweep fails it instead. The
        state is re-checked here so a cancel landing between the
        worker's RETRYING check and this call neither requeues a
        terminal job nor counts a phantom retry."""
        with self._cv:
            requeued = job.state is JobState.RETRYING
            if requeued:
                self._metrics.counter("serving.recovery.retries").inc()
                if job.trace is not None:
                    job.trace.event(
                        "retrying", parent=job.trace.root,
                        attempt=job.attempt,
                        backoff_s=round(max(0.0, (job.not_before or 0)
                                            - time.time()), 4),
                        **({"error": job.error} if job.error else {}))
                self._push_locked(job)
        if not requeued:
            # cancel raced the RETRYING check: finalize OUTSIDE the cv
            # — a terminal job that entered execution dumps its
            # postmortem here, and the bundle write (ring + state
            # serialized to disk) must never stall the scheduler API
            self._finalize_metrics(job)
            return
        # postmortem on the FIRST retry (the failure evidence is
        # freshest now; later attempts overwrite nothing — each dump
        # file is its own sequence-numbered bundle)
        if self.recorder is not None and job.attempt == 2:
            self._dump(job, reason="retrying")

    def _run(self) -> None:
        # the worker's time is tiled by devprof host stages (module doc):
        # serving.wait, serving.dispatch, the batcher's run spans and its
        # serving.result
        while True:
            # autotune tick (olap/serving/autotune): evaluated on the
            # worker thread between batches — the same thread that owns
            # max_batch, so K moves race nothing. Nothing the
            # controller does may take the worker down.
            if self.controller is not None:
                with devprof.stage("serving.dispatch"):
                    try:
                        self.controller.maybe_tick()
                    except Exception:
                        pass
            with self._cv:
                # bounded single wait, NOT a drain-the-heap loop: an
                # idle scheduler must keep cycling through the
                # controller tick above (restores fire when traffic
                # STOPS — the empty-queue state is a control signal,
                # not a reason to sleep forever)
                if not self._stop and not self._heap:
                    with devprof.stage("serving.wait"):
                        self._cv.wait(0.1)
                if self._stop:
                    return
                with devprof.stage("serving.dispatch"):
                    group = self._pop_group()
                if group:
                    self._running_batch = len(group)
                else:
                    # heap holds only backoff-deferred entries: idle
                    # briefly instead of spinning on the pop
                    with devprof.stage("serving.wait"):
                        self._cv.wait(0.05)
            if not group:
                continue
            try:
                self._execute(group)
            except Exception as e:
                # belt and braces: NOTHING may kill the single worker
                # thread (a dead worker leaves every later job QUEUED
                # forever with no error surfaced) — fail the group and
                # keep serving
                for job in group:
                    job.fail(f"scheduler: {type(e).__name__}: {e}")
            finally:
                with self._cv:
                    self._running_batch = 0
            with devprof.stage("serving.dispatch"):
                for job in group:
                    if job.state is JobState.RETRYING:
                        if job.trace is not None \
                                and job.trace.attempt is not None:
                            job.trace.end(job.trace.attempt,
                                          state=JobState.RETRYING.value)
                            job.trace.attempt = None
                        self._requeue(job)
                    else:
                        self._finalize_metrics(job)

    def _attribute(self, group: list[Job], wall: float,
                   nbytes: int) -> None:
        """Resource attribution for one executed batch: the shared
        level loop served all K jobs at once, so the batch wall time —
        and the leased graph image's ledger bytes × that wall — split
        EVENLY across the K members (the amortization-aware split; a
        job's fused cost IS wall/K, that being the whole point of
        fusion). Accumulates on both the per-job view (wire envelope)
        and the per-tenant ledger."""
        if not group or wall <= 0:
            return
        dev_share = wall / len(group)
        hbm_share = nbytes * wall / len(group)
        for job in group:
            job.device_seconds += dev_share
            job.hbm_byte_seconds += hbm_share
            self.tenants.device_seconds(job.tenant, dev_share)
            if hbm_share:
                self.tenants.hbm_byte_seconds(job.tenant, hbm_share)

    def _stitch_device_cost(self, group: list[Job], cost: dict) -> None:
        """Per-job device-cost attribution (obs/devprof):
        the executed batch's profiler window — kernel calls, compiles,
        compile/exec wall, H2D/D2H bytes — lands on each member's trace
        as a ``device_cost`` event, with the divisible costs split
        evenly over the K fused jobs exactly like the device-seconds
        accounting (the whole point of fusion is that a job's share IS
        total/K). Compile and call counts stay batch-wide: a compile is
        shared, not divisible."""
        if not cost["calls"]:
            return
        k = len(group)
        for job in group:
            h = job.trace
            if h is None:
                continue
            h.event("device_cost", k=k,
                    kernel_calls=cost["calls"],
                    compiles=cost["compiles"],
                    compile_ms_share=round(cost["compile_s"] * 1e3 / k,
                                           3),
                    exec_ms_share=round(cost["exec_s"] * 1e3 / k, 3),
                    h2d_bytes_share=cost["h2d_bytes"] // k,
                    d2h_bytes_share=cost["d2h_bytes"] // k)

    def _execute(self, group: list[Job]) -> None:
        head = group[0]
        # serving.dispatch, entered once for each stretch of the worker's
        # own work around the batcher's call (module doc)
        with devprof.stage("serving.dispatch"):
            group = self._start_group(group)
        if not group:
            return
        if head.spec.kind == "callable":
            # host delegations: the function is the job's work, and no
            # run span or stage covers it
            t0 = time.time()
            for job in group:
                self.batcher.run_single(job, None)
            self._attribute(group, time.time() - t0, 0)
            if self.recorder is not None:
                self.recorder.metric_delta()
            return
        spec = head.spec
        with devprof.stage("serving.dispatch"):
            edge_keys = tuple(spec.edge_keys or ())
            if spec.kind == "dense" and not edge_keys:
                # a DenseProgram that reads edge properties needs them
                # extracted into the snapshot — derive from the program
                program = spec.params.get("program")
                if program is not None and hasattr(program, "edge_keys"):
                    edge_keys = tuple(program.edge_keys())
            try:
                # dense window sweeps (pagerank / DenseProgram) have no
                # overlay seam: the live pool folds the overlay into the
                # base BEFORE leasing for these kinds (the documented
                # compact-before-run fallback, models/frontier.py)
                lease = self.pool.acquire(labels=spec.labels,
                                          edge_keys=edge_keys,
                                          directed=spec.directed,
                                          compacted=spec.kind in
                                          ("pagerank", "dense"))
            except Exception as e:
                for job in group:
                    job.fail(f"snapshot: {type(e).__name__}: {e}")
                return
        with lease as snap:
            with devprof.stage("serving.dispatch"):
                overlay = lease.overlay
                epoch_info = lease.epoch_info \
                    or {"epoch": getattr(snap, "epoch", 0)}
                for job in group:
                    job.ran_epoch = epoch_info
                ledger_key = id(snap)
                # mesh-placed cohorts charge the PER-DEVICE share; the
                # predicate is the batcher's (Batcher.would_mesh), so the
                # accounting here and the placement there answer from one
                # definition. A snapshot already resident under the other
                # accounting keeps its first byte count (reserve() pins
                # existing keys without re-pricing), as in the JAX package
                if self.batcher.would_mesh(spec.kind, overlay):
                    nbytes = meshed_snapshot_csr_bytes(snap, self.mesh.size)
                else:
                    nbytes = snapshot_csr_bytes(snap)
                try:
                    self.ledger.reserve(ledger_key, nbytes)
                except AdmissionError as e:
                    for job in group:
                        job.fail(str(e))
                    return
                self._evictable.setdefault(ledger_key, snap)
                # the batch shares one graph image: its ledger bytes are
                # held against each member's tenant (per-K share) for the
                # duration of the run — the live view max_hbm_bytes
                # quotas check against — then released and converted
                # into byte-seconds attribution
                share = nbytes / len(group)
                for job in group:
                    self.tenants.hold_hbm(job.tenant, share)
                t0 = time.time()
                w = self.profiler.window() if self.profiler is not None \
                    else None
            try:
                if len(group) > 1 or batch_key(spec) is not None:
                    self.batcher.run_batch(group, snap,
                                           overlay=overlay)
                else:
                    self.batcher.run_single(group[0], snap,
                                            overlay=overlay)
            finally:
                with devprof.stage("serving.dispatch"):
                    wall = time.time() - t0
                    for job in group:
                        self.tenants.drop_hbm(job.tenant, share)
                    self._attribute(group, wall, nbytes)
                    self.ledger.unpin(ledger_key)
                    if w is not None:
                        self._stitch_device_cost(group, w.close())
                    if self.recorder is not None:
                        self.recorder.metric_delta()

    def _start_group(self, group: list[Job]) -> list[Job]:
        """The group's jobs that start now (a cancel that raced between
        pop and start is honored before any work), started: queue
        histograms, attempt spans, and the enforcing controller's
        applied decisions stitched into their traces."""
        group = [j for j in group
                 if not j.state.terminal
                 and not (j.cancel_requested and j.mark_cancelled())]
        if not group:
            return group
        for job in group:
            first_start = job.started_at is None
            job.start()
            h = job.trace
            if h is not None:
                if first_start and h.queue is not None:
                    h.end(h.queue)
                h.attempt = h.start("attempt", parent=h.root,
                                    attempt=job.attempt)
            q = job.queue_seconds()
            # retry attempts keep the FIRST start time: sample the
            # submit->start latency once per job, not once per attempt
            if q is not None and first_start:
                self._metrics.histogram(
                    "serving.job.queue_ms",
                    labels=self._job_labels(job)).update(q * 1e3)
                self.tenants.queue_ms(job.tenant, q * 1e3)
        self._metrics.histogram("serving.batch.occupancy").update(
            float(len(group)))
        # decision spans (olap/serving/autotune): jobs executing under
        # freshly-APPLIED controller decisions carry them in their
        # traces — the "why did my batch shape change" evidence.
        # Enforce mode only: shadow decisions stay journal/
        # `controller`-trace-only (an unapplied decision affected no
        # job, and the default-shadow hot path must not re-scan the
        # journal per batch for nothing).
        if self.controller is not None \
                and self.controller.mode == "enforce":
            decs = [d for d in self.controller.decisions_since(
                self._ctl_stitch_seq) if d["applied"]]
            if decs:
                self._ctl_stitch_seq = decs[-1]["seq"]
                brief = [{k: d[k] for k in ("seq", "rule", "knob",
                                            "old", "new")}
                         for d in decs]
                for job in group:
                    if job.trace is not None:
                        job.trace.event("controller", decisions=brief)
        return group
