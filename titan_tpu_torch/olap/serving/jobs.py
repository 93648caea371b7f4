"""Job lifecycle for the OLAP serving layer.

A ``Job`` is the handle the scheduler returns at submit time and the
server serializes over the wire: spec + state machine + result/error +
timing fields. States:

    QUEUED ──► RUNNING ──► DONE
       │        │ ▲   ├──► FAILED      (exception / admission rejection
       │        │ │   │                 with no retry budget left)
       │        │ │   ├──► TIMEOUT     (ran past spec.timeout_s)
       │        │ │   ├──► CANCELLED   (DELETE while running — the
       │        │ │   │                 batched kernel drops the job at
       │        │ │   │                 the next level boundary)
       │        ▼ │   │
       │      RETRYING─┴──► CANCELLED  (recovery plane: a retryable
       │       (requeued with backoff;  failure with attempts left —
       │        resumes from its        see olap/recovery; DELETE while
       │        newest checkpoint)      RETRYING cancels immediately)
       ├──► CANCELLED                  (DELETE while queued)
       └──► EXPIRED                    (spec.deadline passed before start)

RETRYING is NON-terminal: ``wait()`` keeps blocking, the scheduler
requeues the job after its backoff (``Job.not_before``) and the next
attempt resumes from the newest valid checkpoint. Terminal transitions
are idempotent-guarded under a lock (a cancel racing completion keeps
whichever landed first) and release ``wait()``; a job can therefore
never go DONE after FAILED.

The port's copy of ``titan_tpu/olap/serving/jobs.py``, host code only.
"""

from __future__ import annotations

import enum
import itertools
import threading
import time
from typing import Any, Optional

from titan_tpu_torch.olap.api import JobSpec


class JobState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    RETRYING = "retrying"
    DONE = "done"
    FAILED = "failed"
    TIMEOUT = "timeout"
    CANCELLED = "cancelled"
    EXPIRED = "expired"

    @property
    def terminal(self) -> bool:
        return self not in (JobState.QUEUED, JobState.RUNNING,
                            JobState.RETRYING)


_ids = itertools.count(1)


class Job:
    """Scheduler-owned job handle. ``result`` is a dict (kind-specific;
    large arrays stay host-side under keys the wire form omits);
    ``batch_k`` records the occupancy of the batch the job ran in (1 for
    single execution) — the amortization evidence per job."""

    def __init__(self, spec: JobSpec):
        from titan_tpu_torch.olap.serving.tenants import effective_tenant
        self.id = f"job-{next(_ids)}"
        self.spec = spec
        self.state = JobState.QUEUED
        self.result: Optional[dict] = None
        self.error: Optional[str] = None
        self.batch_k: int = 0
        # tenancy (olap/serving/tenants): the attribution identity —
        # absent/empty spec.tenant falls back to "default", never a
        # KeyError downstream. device_seconds / hbm_byte_seconds
        # accumulate the job's batch-share of device wall time and
        # ledger bytes x seconds across attempts (the scheduler feeds
        # the per-tenant accounting as it goes; these are the per-job
        # view for the wire envelope)
        self.tenant: str = effective_tenant(getattr(spec, "tenant",
                                                    None))
        self.device_seconds: float = 0.0
        self.hbm_byte_seconds: float = 0.0
        self.submitted_at = time.time()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # recovery plane (olap/recovery): attempt counter, backoff gate,
        # round progress + checkpoint bookkeeping; ``recovery`` is the
        # scheduler-attached JobRecovery (None when disabled)
        self.attempt: int = 1
        # the graph epoch the job's snapshot lease covered (set by the
        # scheduler at lease time; live plane leases carry the
        # compaction epoch + overlay delta seq) — freshness provenance
        # in the wire envelope
        self.ran_epoch: Optional[dict] = None
        self.not_before: Optional[float] = None
        self.retries_exhausted: bool = False
        self.last_round: int = 0
        self.rounds_replayed: int = 0
        self.checkpoint_round: Optional[int] = None
        self.recovery = None
        # observability plane (titan_tpu/obs): the scheduler-attached
        # TraceHandle when tracing is enabled; None otherwise —
        # execution hooks test this ONE attribute, so tracing-off costs
        # nothing per round
        self.trace = None
        # postmortem bundle path (obs/flightrec): set by the scheduler
        # when an abnormal end wrote a dump — GET /jobs/<id> references
        # it so a triager can jump from the job to its bundle
        self.dump_path: Optional[str] = None
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._metered = False

    def metered_once(self) -> bool:
        """True exactly once — the scheduler's guard so a job's terminal
        metrics (state counter + latency sample) are recorded a single
        time even when two paths race to finalize it (e.g. a client
        cancel landing between queue pop and batch start)."""
        with self._lock:
            if self._metered:
                return False
            self._metered = True
            return True

    # -- state machine ------------------------------------------------------

    def _finish(self, state: JobState, *, result: Optional[dict] = None,
                error: Optional[str] = None) -> bool:
        """Terminal transition; returns False if already terminal."""
        with self._lock:
            if self.state.terminal:
                return False
            self.state = state
            self.result = result
            self.error = error
            self.finished_at = time.time()
        self._done.set()
        return True

    def start(self) -> bool:
        """QUEUED/RETRYING → RUNNING (False if the job went terminal
        first). ``started_at`` keeps the FIRST start so queue latency
        is measured once."""
        with self._lock:
            if self.state not in (JobState.QUEUED, JobState.RETRYING):
                return False
            self.state = JobState.RUNNING
            if self.started_at is None:
                self.started_at = time.time()
        return True

    def complete(self, result: dict) -> bool:
        return self._finish(JobState.DONE, result=result)

    def fail(self, error: str, *, permanent: bool = False) -> bool:
        """Record a failure. A RUNNING job with retry budget left
        (``spec.max_retries``) transitions to RETRYING instead of
        FAILED — attempt bumps, ``not_before`` gates the requeue with
        exponential backoff, and ``wait()`` keeps blocking; the
        scheduler requeues it and the next attempt resumes from the
        newest checkpoint. ``permanent=True`` (param errors, scheduler
        shutdown) skips retry and goes straight to FAILED."""
        with self._lock:
            if self.state.terminal:
                return False
            if not permanent and self.state is JobState.RUNNING \
                    and self.spec.max_retries > 0:
                if self.attempt <= self.spec.max_retries:
                    self.state = JobState.RETRYING
                    self.error = error
                    self.not_before = time.time() + \
                        self.spec.retry_backoff_s \
                        * (2 ** (self.attempt - 1))
                    self.attempt += 1
                    return True
                # it is THIS branch declining the retry that means
                # "budget exhausted" — a later permanent failure (param
                # error, scheduler close) must not read as exhaustion
                self.retries_exhausted = True
        return self._finish(JobState.FAILED, error=error)

    def expire(self) -> bool:
        return self._finish(JobState.EXPIRED, error="deadline passed "
                            "before the job started")

    def time_out(self) -> bool:
        return self._finish(JobState.TIMEOUT,
                            error=f"exceeded timeout_s="
                                  f"{self.spec.timeout_s}")

    def cancel(self) -> bool:
        """Request cancellation. A queued job goes CANCELLED now; a
        running one is dropped from its batch at the next level boundary
        (the worker observes ``cancel_requested``). Returns False only
        when the job already finished in another state."""
        self._cancel.set()
        with self._lock:
            if self.state.terminal:
                return self.state is JobState.CANCELLED
            if self.state is JobState.RUNNING:
                return True   # the worker completes the transition
            self.state = JobState.CANCELLED
            self.finished_at = time.time()
        self._done.set()
        return True

    def mark_cancelled(self) -> bool:
        return self._finish(JobState.CANCELLED)

    @property
    def cancel_requested(self) -> bool:
        return self._cancel.is_set()

    # -- observation --------------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until terminal; True if it finished within timeout."""
        return self._done.wait(timeout)

    def queue_seconds(self) -> Optional[float]:
        if self.started_at is None:
            return None
        return self.started_at - self.submitted_at

    def exec_seconds(self) -> Optional[float]:
        if self.started_at is None or self.finished_at is None:
            return None
        return self.finished_at - self.started_at

    def to_wire(self) -> dict:
        """JSON-safe summary (large result arrays omitted)."""
        out: dict[str, Any] = {
            "job": self.id,
            "kind": self.spec.kind,
            "status": self.state.value,
            "priority": self.spec.priority,
            "tenant": self.tenant,
            "submitted_at": self.submitted_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
            "batch_k": self.batch_k,
            "attempt": self.attempt,
        }
        if self.device_seconds:
            out["device_ms"] = round(self.device_seconds * 1e3, 3)
        if self.hbm_byte_seconds:
            out["hbm_byte_seconds"] = round(self.hbm_byte_seconds, 3)
        if self.ran_epoch is not None:
            out["epoch"] = self.ran_epoch
        if self.spec.max_retries:
            out["max_retries"] = self.spec.max_retries
        if self.checkpoint_round is not None:
            out["checkpoint_round"] = self.checkpoint_round
        if self.rounds_replayed:
            out["rounds_replayed"] = self.rounds_replayed
        if self.state is JobState.RETRYING and self.not_before is not None:
            out["retry_at"] = self.not_before
        q, e = self.queue_seconds(), self.exec_seconds()
        if q is not None:
            out["queue_ms"] = round(q * 1e3, 3)
        if e is not None:
            out["exec_ms"] = round(e * 1e3, 3)
        if self.error is not None:
            out["error"] = self.error
        if self.dump_path is not None:
            out["postmortem"] = self.dump_path
        if self.result is not None:
            out["result"] = {
                k: v for k, v in self.result.items()
                if isinstance(v, (int, float, str, bool, list, dict))
                or v is None}
        return out

    def __repr__(self) -> str:
        return f"<Job {self.id} {self.spec.kind} {self.state.value}>"
