"""Declarative SLOs over the metrics registry: error-budget burn rates.

The judgement layer of the per-tenant plane: objectives are
declared per tenant and/or per algorithm (job kind), evaluated from the
labeled metric children the serving scheduler already writes — the
engine READS the registry, it never instruments anything itself — and
reported as multi-window error-budget burn rates:

* a **success-rate** objective (``success_rate=0.999``) counts good =
  ``serving.jobs.completed`` and bad = ``serving.jobs.failed`` +
  ``serving.jobs.timeout`` children matching the objective's selector
  (cancelled/expired jobs never entered execution, so they are neither);
* a **p95-latency** objective (``p95_ms=50``) reads the matching
  ``serving.job.latency_ms`` children: an event is bad when it exceeded
  the threshold — reconstructed from each child's reservoir as
  ``count * (samples_over / samples)``, which is EXACT while the
  reservoir has not overflowed (tests pin this against hand-computed
  fixtures) and a uniform estimate after.

Burn rate per window ``W``::

    error_rate(W) = bad events in the last W / total events in the last W
    burn_rate(W)  = error_rate(W) / error_budget

where the budget is ``1 - success_rate`` for success objectives and
``0.05`` for p95 objectives (5% of events may exceed a p95 target by
definition). Burn 1.0 = spending exactly the budget; 14.4 over 1h is
the classic page threshold. Windowed counts come from an internal ring
of cumulative snapshots taken at evaluation time (the clock is
injectable; points older than needed are pruned, and a window reaching
past recorded history reads a zero baseline — correct for a process
younger than the window).

``register_gauges()`` exports every (objective, window) pair as a
labeled ``serving.slo.burn_rate`` gauge; the scrape callback
re-evaluates at most once per ``min_record_s``, so Prometheus itself
drives the sampling. ``GET /slo`` on the server returns ``evaluate()``'s
full report.

The port's copy of ``titan_tpu/obs/slo.py``, host code only.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from titan_tpu_torch.utils.metrics import MetricManager, nearest_rank

#: default burn-rate windows (seconds): the fast page window and the
#: slow ticket window of the classic multi-window alerting pair
DEFAULT_WINDOWS = (300.0, 3600.0)

#: the 5% of events a p95 objective allows over its threshold
P95_BUDGET = 0.05

_GOOD_STATES = ("completed",)
_BAD_STATES = ("failed", "timeout")


@dataclass(frozen=True)
class SLO:
    """One objective: exactly ONE of ``p95_ms`` / ``success_rate``.
    ``tenant`` / ``algorithm`` (job kind) select the labeled metric
    children the SLI is computed from; both unset = the whole plane.

    ``metric`` (p95 objectives only): the latency histogram the SLI
    reads — default ``serving.job.latency_ms`` (the heavy OLAP queue);
    the interactive lane's p95 objective points it at
    ``serving.interactive.latency_ms``."""

    name: str
    tenant: Optional[str] = None
    algorithm: Optional[str] = None
    p95_ms: Optional[float] = None
    success_rate: Optional[float] = None
    windows: tuple = DEFAULT_WINDOWS
    metric: Optional[str] = None

    def __post_init__(self):
        if (self.p95_ms is None) == (self.success_rate is None):
            raise ValueError(
                f"SLO {self.name!r}: set exactly one of p95_ms / "
                f"success_rate (two targets = two objectives)")
        if self.success_rate is not None \
                and not 0.0 < self.success_rate < 1.0:
            raise ValueError(f"SLO {self.name!r}: success_rate must be "
                             f"in (0, 1), got {self.success_rate}")
        if self.metric is not None and self.p95_ms is None:
            raise ValueError(
                f"SLO {self.name!r}: metric= selects a latency "
                "histogram, which only a p95_ms objective reads")
        if not self.windows:
            raise ValueError(f"SLO {self.name!r}: needs >= 1 window")

    @property
    def selector(self) -> dict:
        sel = {}
        if self.tenant is not None:
            sel["tenant"] = self.tenant
        if self.algorithm is not None:
            sel["kind"] = self.algorithm
        return sel

    @property
    def budget(self) -> float:
        return (1.0 - self.success_rate) \
            if self.success_rate is not None else P95_BUDGET


def _window_key(w: float) -> str:
    # shortest exact-ish float form ("300s", "60.4s") — truncating to
    # int would collide distinct sub-second-differing windows into one
    # report key / ring key / gauge label
    return f"{w:g}s"


class SLOEngine:
    """See module doc. One engine per scheduler (attached via
    ``JobScheduler(slos=[...])``); independently constructible for
    tests with an injected clock."""

    LATENCY_METRIC = "serving.job.latency_ms"

    def __init__(self, metrics: MetricManager, objectives,
                 clock=None, min_record_s: float = 1.0):
        self.metrics = metrics
        self.objectives = list(objectives)
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.clock = clock or time.time
        self.min_record_s = float(min_record_s)
        # ring of (t, {slo name: (total, bad)}) cumulative snapshots —
        # the baseline store windowed deltas are computed against
        self._points: list = []
        self._last: dict = {}       # (name, window) -> burn rate
        self._lock = threading.Lock()

    # -- SLI counts (cumulative since process start) -------------------------

    def _success_counts(self, slo: SLO) -> tuple:
        sel = slo.selector
        good = sum(self.metrics.counter_value(f"serving.jobs.{s}",
                                              labels=sel)
                   for s in _GOOD_STATES)
        bad = sum(self.metrics.counter_value(f"serving.jobs.{s}",
                                             labels=sel)
                  for s in _BAD_STATES)
        return good + bad, float(bad)

    def _latency_metric(self, slo: SLO) -> str:
        return slo.metric or self.LATENCY_METRIC

    def _latency_counts(self, slo: SLO) -> tuple:
        total, bad = 0, 0.0
        for _lbls, h in self.metrics.children(self._latency_metric(slo),
                                              slo.selector):
            total += h.count
            samples = h.values()
            if samples:
                over = sum(1 for v in samples if v > slo.p95_ms)
                bad += h.count * (over / len(samples))
        return total, bad

    def _counts(self, slo: SLO) -> tuple:
        return (self._latency_counts(slo) if slo.p95_ms is not None
                else self._success_counts(slo))

    def _current(self, slo: SLO, total: int, bad: float) -> dict:
        """The objective's CURRENT (cumulative) SLI reading + verdict;
        no data = within objective (an idle tenant is not in breach)."""
        if slo.p95_ms is not None:
            pooled: list = []
            for _lbls, h in self.metrics.children(self._latency_metric(slo),
                                                  slo.selector):
                pooled.extend(h.values())
            if not pooled:
                return {"p95_ms": None, "ok": True}
            p95 = nearest_rank(pooled, 0.95)
            return {"p95_ms": p95, "ok": p95 <= slo.p95_ms}
        if total == 0:
            return {"success_rate": None, "ok": True}
        rate = 1.0 - bad / total
        return {"success_rate": rate, "ok": rate >= slo.success_rate}

    # -- windowed burn rates -------------------------------------------------

    def _baseline(self, t_cut: float, name: str) -> tuple:
        """Newest recorded point at/before ``t_cut`` (zeros when the
        window reaches past history — counts started at zero)."""
        base = (0, 0.0)
        for t, counts in self._points:
            if t > t_cut:
                break
            base = counts.get(name, (0, 0.0))
        return base

    def evaluate(self) -> dict:
        """Sample every objective, record a ring point (coalesced to
        ``min_record_s``), and return the full ``GET /slo`` report."""
        now = self.clock()
        counts = {o.name: self._counts(o) for o in self.objectives}
        with self._lock:
            if not self._points or now - self._points[-1][0] \
                    >= self.min_record_s:
                self._points.append((now, counts))
                # prune: keep the newest point older than every window
                # (it is some window's baseline) plus everything after
                horizon = now - max(max(o.windows)
                                    for o in self.objectives) \
                    if self.objectives else now
                while len(self._points) >= 2 \
                        and self._points[1][0] <= horizon:
                    self._points.pop(0)
            slos = []
            for o in self.objectives:
                total, bad = counts[o.name]
                windows = {}
                for w in o.windows:
                    b_total, b_bad = self._baseline(now - w, o.name)
                    d_total = total - b_total
                    # clamped at zero: the latency SLI's cumulative bad
                    # count is a reservoir ESTIMATE (count x
                    # over-fraction) and can shrink once the reservoir
                    # overflows and good samples displace bad ones — a
                    # negative windowed delta would export a negative
                    # burn rate
                    d_bad = max(0.0, bad - b_bad)
                    err = d_bad / d_total if d_total > 0 else 0.0
                    burn = err / o.budget
                    self._last[(o.name, _window_key(w))] = burn
                    windows[_window_key(w)] = {
                        "burn_rate": round(burn, 6),
                        "events": d_total, "bad": round(d_bad, 6)}
                objective = {"p95_ms": o.p95_ms,
                             **({"metric": o.metric}
                                if o.metric is not None else {})} \
                    if o.p95_ms is not None \
                    else {"success_rate": o.success_rate}
                slos.append({"slo": o.name, "tenant": o.tenant,
                             "algorithm": o.algorithm,
                             "objective": objective,
                             "sli": {"events": total,
                                     "bad": round(bad, 6),
                                     **self._current(o, total, bad)},
                             "windows": windows})
        return {"evaluated_at": now, "slos": slos}

    def burn_rate(self, name: str, window: float) -> float:
        """Latest burn rate for (objective, window), refreshing the
        evaluation when the coalescing interval has elapsed — the
        scrape path, so Prometheus drives the ring's sampling."""
        with self._lock:
            stale = not self._points or \
                self.clock() - self._points[-1][0] >= self.min_record_s
        if stale:
            self.evaluate()
        with self._lock:
            return self._last.get((name, _window_key(window)), 0.0)

    def register_gauges(self) -> None:
        """Export every (objective, window) pair as a labeled
        ``serving.slo.burn_rate`` gauge. The (gauge, fn) pairs are kept
        so ``detach_gauges`` can neutralize them: the registry may be
        process-global, and each callback closes over this engine."""
        self._gauges = []
        for o in self.objectives:
            for w in o.windows:
                fn = (lambda n=o.name, win=w:
                      self.burn_rate(n, win))
                g = self.metrics.gauge(
                    "serving.slo.burn_rate", fn=fn,
                    labels={"slo": o.name, "window": _window_key(w)})
                self._gauges.append((g, fn))

    def detach_gauges(self) -> None:
        """Drop this engine's burn-rate callbacks from the registry
        (identity-checked: a successor engine that re-registered over
        the same labels must not be clobbered) — a closed scheduler's
        engine must not keep evaluating on every scrape."""
        for g, fn in getattr(self, "_gauges", ()):
            if g.fn is fn:
                g.fn = None
                g.set(0.0)
        self._gauges = []
