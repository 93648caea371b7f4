"""Deterministic fault injection for the recovery test matrix (the
port's copy of ``titan_tpu/olap/recovery/faults.py``; the evict fault
clears the port snapshot's device graphs).

Every recovery path (crash → RETRYING → resume, corrupt checkpoint →
fallback, snapshot eviction → rebuild) must be drivable WITHOUT
flakiness, so the injector is a declarative plan of exact round
indices, not a random killer: the round-boundary hooks in the batcher
call ``FaultPlan.check(round, attempt, snapshot)`` and the plan raises
on the configured round — only while ``attempt <= fail_attempts``, so
a retried attempt runs clean and the test observes recovery, not an
infinite crash loop.

Fault matrix (docs/recovery.md):

  crash_at_round    raise InjectedFault at round k (worker death /
                    host preemption analog — the whole batch dies)
  evict_at_round    drop the snapshot's device-resident caches, then
                    raise SnapshotEvicted (HBM eviction race analog;
                    the retry re-uploads from host arrays)
  corrupt_at_round  after the checkpoint written at round k commits,
                    flip bytes inside one array payload on disk (torn
                    storage analog; the NEXT resume must reject it by
                    digest and fall back)
  slow_write_s      sleep before every checkpoint write (slow-disk
                    analog; exercises checkpoint-vs-cancel timing)

``FaultPlan.seeded(seed, max_round)`` derives the crash round from a
seeded RNG — deterministic per seed, for property tests that sweep
crash positions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np


class InjectedFault(RuntimeError):
    """Deterministic injected worker fault (test harness only)."""


class SnapshotEvicted(InjectedFault):
    """Injected mid-job loss of the snapshot's device residency."""




@dataclass
class FaultPlan:
    """Declarative, deterministic fault schedule for ONE job."""

    crash_at_round: Optional[int] = None
    evict_at_round: Optional[int] = None
    corrupt_at_round: Optional[int] = None
    slow_write_s: float = 0.0
    #: inject only while attempt <= this (default: first attempt only)
    fail_attempts: int = 1

    def check(self, round_: int, attempt: int, snapshot=None) -> None:
        """Round-boundary hook: raise the configured fault, if due."""
        if attempt > self.fail_attempts:
            return
        if self.evict_at_round is not None and round_ == self.evict_at_round:
            # the snapshot's device caches (olap/engine.device_graph,
            # models/bfs_hybrid.build_chunked_csr): the retried attempt
            # uploads them again
            for attr in ("_device_graphs", "_hybrid_csr_by_device"):
                caches = getattr(snapshot, attr, None)
                if caches is not None:
                    caches.clear()
            raise SnapshotEvicted(
                f"injected: snapshot evicted at round {round_} "
                f"(attempt {attempt})")
        if self.crash_at_round is not None and round_ == self.crash_at_round:
            raise InjectedFault(
                f"injected: crash at round {round_} (attempt {attempt})")

    def should_corrupt(self, round_: int, attempt: int) -> bool:
        return (self.corrupt_at_round is not None
                and attempt <= self.fail_attempts
                and round_ == self.corrupt_at_round)

    @staticmethod
    def corrupt(path: str) -> None:
        """Flip bytes inside the LARGEST array payload of a COMMITTED
        checkpoint directory — the manifest stays intact, so only the
        digest check can catch it (the scenario under test). Raises
        rather than silently not corrupting (a no-op here would make a
        fallback test pass without exercising the rejection path)."""
        cands = [(os.path.getsize(os.path.join(path, f)), f)
                 for f in os.listdir(path) if f.endswith(".npy")]
        if not cands:
            raise FileNotFoundError(f"no array payload to corrupt in {path}")
        size, name = max(cands)
        fp = os.path.join(path, name)
        with open(fp, "r+b") as f:
            # stay clear of the .npy header (~128B): damage data
            off = max(128, size - 16)
            f.seek(off)
            chunk = f.read(4)
            if not chunk:
                raise ValueError(
                    f"{name} too small to corrupt past its header "
                    f"({size} bytes)")
            f.seek(off)
            f.write(bytes(b ^ 0xFF for b in chunk))

    @classmethod
    def seeded(cls, seed: int, max_round: int, **kwargs) -> "FaultPlan":
        """Crash round drawn deterministically from ``seed`` in
        [1, max_round) — same seed, same plan, every run."""
        rng = np.random.default_rng(seed)
        k = int(rng.integers(1, max(2, int(max_round))))
        return cls(crash_at_round=k, **kwargs)
