"""Per-job binding of the checkpoint plane: cadence, faults, metrics
(the port's copy of ``titan_tpu/olap/recovery/checkpoint.py``; ``metrics``
is a ``store.Counters`` or None). The scheduler and batcher named below
are the port's ``olap/serving/``.

The scheduler attaches a ``JobRecovery`` to a job at submit time when
checkpointing is enabled (``JobScheduler(checkpoint_dir=...)`` +
``JobSpec.checkpoint_every > 0``) or a fault plan is injected; the
batcher then drives it from the round-boundary hooks:

* ``due(round)`` — is a checkpoint owed at this round (cadence)?
* ``save(round, arrays, ...)`` — write one checkpoint for this job's
  current attempt through the store (applying the slow-write /
  corrupt-after-commit faults, which must wrap the REAL write path);
* ``latest(kind=, epoch=)`` — newest valid checkpoint that is safe to
  resume from: kind must match, and when the snapshot carries an epoch
  the checkpoint must have been captured at the SAME epoch — a
  refreshed snapshot means the graph changed under the job, so a
  deterministic resume is unsound and the job restarts clean instead
  (never a wrong answer);
* ``resumed(round)`` / ``restarted()`` — metrics bookkeeping at the
  start of a retry attempt: ``serving.recovery.resumes`` and
  ``serving.recovery.rounds_replayed`` (rounds the previous attempt
  had executed past the adopted checkpoint — the work the crash cost).
"""

from __future__ import annotations

import time
from typing import Optional

from titan_tpu_torch.olap.recovery.store import Checkpoint, CheckpointStore


class JobRecovery:
    """One job's handle on the checkpoint & fault plane. ``store`` may
    be None (fault injection without checkpointing: retries restart
    clean)."""

    def __init__(self, store: Optional[CheckpointStore], job,
                 every: int = 0, faults=None, metrics=None,
                 key: Optional[str] = None):
        self.store = store
        self.job = job
        self.every = int(every or 0)
        self.faults = faults
        self._metrics = metrics
        # store key: job ids restart at job-1 per PROCESS while the
        # store persists on disk, so the scheduler namespaces the key
        # with a per-instance nonce — a restarted server must never
        # adopt a previous process's checkpoint for an unrelated job
        self.key = key if key is not None else job.id

    # -- write side ----------------------------------------------------------

    def due(self, round_: int) -> bool:
        return (self.store is not None and self.every > 0
                and round_ > 0 and round_ % self.every == 0)

    def save(self, round_: int, arrays: dict, *, kind: str,
             meta: Optional[dict] = None,
             objects: Optional[dict] = None) -> str:
        t0 = time.time()
        if self.faults is not None and self.faults.slow_write_s > 0:
            time.sleep(self.faults.slow_write_s)
        path = self.store.save(self.key, attempt=self.job.attempt,
                               round_=round_, kind=kind, arrays=arrays,
                               meta=meta, objects=objects)
        self.job.checkpoint_round = round_
        h = getattr(self.job, "trace", None)
        if h is not None:    # obs: commit latency in the job's timeline
            h.event("checkpoint", t0=t0, round=round_)
        if self.faults is not None \
                and self.faults.should_corrupt(round_, self.job.attempt):
            self.faults.corrupt(path)
        return path

    # -- resume side ---------------------------------------------------------

    def latest(self, *, kind: str, epoch=None) -> Optional[Checkpoint]:
        if self.store is None:
            return None
        ck = self.store.latest(self.key)
        if ck is None or ck.kind != kind:
            return None
        if epoch is not None and ck.meta.get("epoch") != epoch:
            return None     # snapshot changed under the job: clean restart
        return ck

    def resumed(self, round_: int) -> None:
        """An execution attempt is starting FROM a checkpoint at
        ``round_``."""
        replayed = max(0, int(self.job.last_round) - int(round_))
        self.job.rounds_replayed += replayed
        h = getattr(self.job, "trace", None)
        if h is not None:
            h.event("resume", from_round=int(round_),
                    rounds_replayed=replayed)
        if self._metrics is not None:
            self._metrics.counter("serving.recovery.resumes").inc()
            if replayed:
                self._metrics.counter(
                    "serving.recovery.rounds_replayed").inc(replayed)

    def restarted(self) -> None:
        """A retry attempt is starting CLEAN (no usable checkpoint):
        every round the failed attempt ran is replayed."""
        replayed = max(0, int(self.job.last_round))
        self.job.rounds_replayed += replayed
        h = getattr(self.job, "trace", None)
        if h is not None:
            h.event("restart_clean", rounds_replayed=replayed)
        if self._metrics is not None and replayed:
            self._metrics.counter(
                "serving.recovery.rounds_replayed").inc(replayed)
