"""Metrics: counters/timers registry + instrumented store wrappers (the
port's copy of ``titan_tpu/utils/metrics.py``: the registry, the
scheduled console/CSV/Graphite reporters and the instrumented stores
that ``metrics.enabled`` wires under the store cache, with the JAX
package's metric names and output).

The registry is pure host-side bookkeeping; device-side timing comes
from ``obs/devprof``'s CUDA events, not from here. The instrumented
wrapper sits *under* the expiration cache so cache hits do not count as
backend ops.

Dimensional children: ``counter(name, labels={...})`` (and the
timer/histogram analogs) returns a LABELED CHILD of the unlabeled parent
— every update lands on both, so the children of a name always sum
exactly to its parent and every pre-label consumer (``counter_value``,
``snapshot()``, CSV) keeps reading the parent unchanged. Children
surface only through the dimensional reads (``labeled()`` /
``children()`` / ``counter_value(name, labels=...)``); ``snapshot()``
keeps the unlabeled schema. Label sets are capped per name
(``MAX_CHILDREN``) — an over-cardinality label set degrades to the
parent rather than growing the registry without bound.

``Gauge`` is the current-value kind (callback-backed, read at export
time — device-memory residency, snapshot-pool size, SLO burn rates);
gauges live outside ``snapshot()`` (they are views, not accumulations)
and export through ``gauge_snapshot()``. Bidirectional counters (queue
depth inc/dec) are flagged ``gauge=True`` at creation.

``MetricManager.instance()`` is the port's own process-global registry,
separate from the JAX package's.
"""

from __future__ import annotations

import csv
import io
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

from titan_tpu_torch.storage.api import (Entry, KeyColumnValueStore,
                                         KeyColumnValueStoreManager,
                                         KeySliceQuery, SliceQuery,
                                         StoreTransaction)

# merged-store metric naming: per-store metrics roll up under these merged
# names exactly like the reference (reference: Backend.java:83-86
# METRICS_MERGED_STORE / METRICS_MERGED_CACHE)
MERGED_STORE = "storeManager"
MERGED_CACHE = "cache"

M_CALLS = "calls"
M_TIME = "time"
M_EXCEPTIONS = "exceptions"
M_ENTRIES_COUNT = "entries-returned"


@dataclass
class Counter:
    #: ``gauge=True`` marks a counter whose value moves in BOTH
    #: directions (current-level bookkeeping like queue depth) — the
    #: Prometheus exposition renders it as a gauge, since
    #: rate()/increase() over a "counter" would read every decrement as
    #: a counter reset
    count: int = 0
    gauge: bool = False
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.count += n


@dataclass
class Timer:
    """Latency accumulator: count, total/min/max nanoseconds."""
    count: int = 0
    total_ns: int = 0
    min_ns: int = 0
    max_ns: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def update(self, elapsed_ns: int) -> None:
        with self._lock:
            if self.count == 0 or elapsed_ns < self.min_ns:
                self.min_ns = elapsed_ns
            if elapsed_ns > self.max_ns:
                self.max_ns = elapsed_ns
            self.count += 1
            self.total_ns += elapsed_ns

    @property
    def mean_ns(self) -> float:
        return self.total_ns / self.count if self.count else 0.0


def nearest_rank(samples, q: float, *, presorted: bool = False) -> float:
    """Nearest-rank percentile (``q`` in [0, 1]) over a value list —
    THE percentile definition of the whole plane: Histogram.percentile,
    the SLO engine's pooled p95 and bench's per-tenant lines all call
    this one function, so they can never drift apart. Unsorted input
    accepted (``presorted=True`` skips the sort — Histogram's memoized
    reservoir path); empty reads 0.0."""
    if not samples:
        return 0.0
    s = samples if presorted else sorted(samples)
    rank = max(0, min(len(s) - 1, int(round(q * (len(s) - 1)))))
    return s[rank]


class Histogram:
    """Sampled value distribution with percentiles — the serving layer's
    p50/p95 job-latency and batch-occupancy metric (the reference's
    Dropwizard histograms play this role; docs/monitoring.txt latency
    domains). Bounded reservoir (Vitter's algorithm R, deterministic
    per-instance LCG — never the process-global RNG — so p50/p95
    assertions are reproducible; ``seed`` is injectable for tests that
    sweep reservoirs): under ``max_samples`` updates the percentiles
    are exact, beyond that a uniform sample."""

    #: default LCG state — every Histogram built without a seed samples
    #: identically given identical update sequences
    DEFAULT_SEED = 0x2545F4914F6CDD1D

    def __init__(self, max_samples: int = 2048,
                 seed: Optional[int] = None):
        self._max = max_samples
        self._samples: list[float] = []
        self.count = 0
        self.total = 0.0
        self.min = 0.0
        self.max = 0.0
        self._rng_state = (self.DEFAULT_SEED if seed is None
                           else int(seed) & (2**64 - 1)) or 1
        # quantile memo: a Prometheus scrape reads
        # p50 AND p95 off every histogram; re-sorting the full reservoir
        # per read made scrape cost O(scrapes * histograms * n log n).
        # The sorted reservoir is cached and keyed on the update-count
        # watermark — EVERY update bumps ``count`` (including reservoir
        # replacements), so a stale cache is impossible.
        self._sorted_memo: Optional[tuple] = None   # (count, sorted)
        self._lock = threading.Lock()

    def _rand(self, bound: int) -> int:
        self._rng_state = (self._rng_state * 6364136223846793005
                           + 1442695040888963407) & (2**64 - 1)
        return (self._rng_state >> 33) % bound

    def update(self, value: float) -> None:
        value = float(value)
        with self._lock:
            if self.count == 0 or value < self.min:
                self.min = value
            if self.count == 0 or value > self.max:
                self.max = value
            self.count += 1
            self.total += value
            if len(self._samples) < self._max:
                self._samples.append(value)
            else:
                i = self._rand(self.count)
                if i < self._max:
                    self._samples[i] = value

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def _sorted_samples(self) -> list:
        """The sorted reservoir, memoized on the sample-count watermark
        (one sort per update generation however many quantiles are
        read). Readers get the shared list — treat it as immutable."""
        with self._lock:
            memo = self._sorted_memo
            if memo is not None and memo[0] == self.count:
                return memo[1]
            s = sorted(self._samples)
            self._sorted_memo = (self.count, s)
            return s

    def percentile(self, q: float) -> float:
        """q in [0, 100]; nearest-rank over the reservoir."""
        return nearest_rank(self._sorted_samples(), q / 100.0,
                            presorted=True)

    def to_dict(self) -> dict:
        s = self._sorted_samples()   # ONE sort feeds both quantiles
        return {"count": self.count, "mean": self.mean, "min": self.min,
                "max": self.max, "total": self.total,
                "p50": nearest_rank(s, 0.5, presorted=True),
                "p95": nearest_rank(s, 0.95, presorted=True),
                # how many reservoir samples back the percentiles —
                # below max_samples they are exact, not estimates
                "samples": len(s)}

    def values(self) -> list:
        """Reservoir snapshot (unordered) — the SLO engine pools these
        across labeled children for cross-kind percentiles; under
        ``max_samples`` updates this is the EXACT value set."""
        with self._lock:
            return list(self._samples)


class Gauge:
    """Current-value metric, read at export time. ``fn`` (a zero-arg
    callable returning a number) makes it a live view — HBM residency,
    snapshot-pool size, SLO burn rates; without a callback it holds the
    last ``set()`` value. A raising/broken callback reads as 0.0: a dead
    gauge must never take a scrape (or a reporter thread) down."""

    __slots__ = ("fn", "_value")

    def __init__(self, fn=None):
        self.fn = fn
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def read(self) -> float:
        if self.fn is None:
            return self._value
        try:
            return float(self.fn())
        except Exception:
            return 0.0


class _LabeledCounter:
    """Labeled child handle: increments land on the child AND its
    unlabeled parent, so children always sum exactly to the parent and
    every pre-label read of the parent is unchanged."""

    __slots__ = ("child", "parent", "labels")

    def __init__(self, child: Counter, parent: Counter, labels: dict):
        self.child = child
        self.parent = parent
        self.labels = labels

    @property
    def count(self) -> int:
        return self.child.count

    def inc(self, n: int = 1) -> None:
        self.child.inc(n)
        self.parent.inc(n)

    def stats(self) -> dict:
        return {"type": "counter", "count": self.child.count}


class _LabeledTimer:
    __slots__ = ("child", "parent", "labels")

    def __init__(self, child: Timer, parent: Timer, labels: dict):
        self.child = child
        self.parent = parent
        self.labels = labels

    @property
    def count(self) -> int:
        return self.child.count

    def update(self, elapsed_ns: int) -> None:
        self.child.update(elapsed_ns)
        self.parent.update(elapsed_ns)

    def stats(self) -> dict:
        c = self.child
        return {"type": "timer", "count": c.count,
                "mean_ms": c.mean_ns / 1e6, "min_ms": c.min_ns / 1e6,
                "max_ms": c.max_ns / 1e6, "total_ms": c.total_ns / 1e6}


class _LabeledHistogram:
    __slots__ = ("child", "parent", "labels")

    def __init__(self, child: Histogram, parent: Histogram, labels: dict):
        self.child = child
        self.parent = parent
        self.labels = labels

    @property
    def count(self) -> int:
        return self.child.count

    def update(self, value: float) -> None:
        self.child.update(value)
        self.parent.update(value)

    def percentile(self, q: float) -> float:
        return self.child.percentile(q)

    def values(self) -> list:
        return self.child.values()

    def to_dict(self) -> dict:
        return self.child.to_dict()

    def stats(self) -> dict:
        return {"type": "histogram", **self.child.to_dict()}


def _labels_key(labels: dict) -> tuple:
    """Canonical child key: sorted (str(k), str(v)) pairs — label order
    at the call site never creates a second child."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricManager:
    """Named-metric registry. One shared default instance (the reference's
    ``MetricManager.INSTANCE`` singleton), but independently constructible
    for test isolation."""

    _instance: Optional["MetricManager"] = None
    _instance_lock = threading.Lock()

    #: labeled-children cap PER metric name: label values often arrive
    #: from the wire (tenant ids), and an unbounded label set would let
    #: one abusive caller grow the registry forever — past the cap a
    #: NEW label set degrades to the unlabeled parent (existing
    #: children keep working)
    MAX_CHILDREN = 256

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._timers: dict[str, Timer] = {}
        self._histograms: dict[str, Histogram] = {}
        # name -> {labels_key: _Labeled*} (one family dict per name;
        # the proxy holds the child metric + the labels dict)
        self._children: dict[str, dict] = {}
        self._gauges: dict[str, Gauge] = {}
        self._gauge_children: dict[str, dict] = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "MetricManager":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = MetricManager()
            return cls._instance

    #: counter name recording every cardinality degrade (see _child) —
    #: created lazily on the first drop, so a run that never overflows
    #: has a byte-identical snapshot/export to the pre-label contract
    LABELS_DROPPED = "metrics.labels.dropped"

    def _child(self, name: str, labels: dict, parent, make, proxy):
        key = _labels_key(labels)
        with self._lock:
            fam = self._children.setdefault(name, {})
            p = fam.get(key)
            if p is None:
                if len(fam) >= self.MAX_CHILDREN:
                    # cardinality guard: degrade to the parent — but
                    # NEVER silently. A dropped label set means the
                    # family's children no longer sum to the parent
                    # and any per-label reader (SLO selectors,
                    # /metrics children) is blind to this label set,
                    # so the degrade itself must be observable.
                    self._counters.setdefault(
                        self.LABELS_DROPPED, Counter()).inc()
                    return parent
                p = proxy(make(), parent, dict(key))
                fam[key] = p
            return p

    def counter(self, name: str, labels: Optional[dict] = None,
                gauge: bool = False):
        """Unlabeled parent, or (with ``labels``) the labeled child
        whose increments roll up into it. ``gauge=True`` flags the name
        as bidirectional for the Prometheus exposition (sticky once
        set)."""
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        if gauge and not c.gauge:
            c.gauge = True
        if labels:
            return self._child(name, labels, c, Counter, _LabeledCounter)
        return c

    def timer(self, name: str, labels: Optional[dict] = None):
        t = self._timers.get(name)
        if t is None:
            with self._lock:
                t = self._timers.setdefault(name, Timer())
        if labels:
            return self._child(name, labels, t, Timer, _LabeledTimer)
        return t

    def histogram(self, name: str, seed: Optional[int] = None,
                  labels: Optional[dict] = None):
        """``seed`` applies only when this call CREATES the histogram
        (reservoir sampling state is per-instance; see Histogram)."""
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name,
                                                Histogram(seed=seed))
        if labels:
            return self._child(name, labels, h, Histogram,
                               _LabeledHistogram)
        return h

    def gauge(self, name: str, fn=None,
              labels: Optional[dict] = None) -> Gauge:
        """Get-or-create a gauge; ``fn`` (when given) re-binds the
        callback — latest registration wins, so a recreated owner (a
        new scheduler over the shared registry) takes over its gauges
        instead of leaving stale closures behind."""
        with self._lock:
            g = self._gauges.setdefault(name, Gauge())
            if labels:
                fam = self._gauge_children.setdefault(name, {})
                key = _labels_key(labels)
                g = fam.setdefault(key, Gauge())
        if fn is not None:
            g.fn = fn
        return g

    def gauge_value(self, name: str, labels: Optional[dict] = None
                    ) -> float:
        """A labeled gauge's read, or the parent's — a parent with no
        callback of its own reads as the SUM of its children (the
        roll-up contract, mirrored from counters)."""
        with self._lock:
            g = self._gauges.get(name)
            fam = dict(self._gauge_children.get(name) or {})
        if labels is not None:
            c = fam.get(_labels_key(labels))
            return c.read() if c is not None else 0.0
        if g is None:
            return 0.0
        if g.fn is None and fam:
            return sum(c.read() for c in fam.values())
        return g.read()

    def counter_value(self, name: str,
                      labels: Optional[dict] = None) -> int:
        """Parent count, or (with ``labels``) the sum over children
        whose label sets CONTAIN every given pair — so
        ``counter_value("serving.jobs.completed", {"tenant": "a"})``
        aggregates tenant ``a`` across its per-kind children."""
        if labels:
            return sum(c.count
                       for _lbls, c in self.children(name, labels))
        c = self._counters.get(name)
        return c.count if c is not None else 0

    def children(self, name: str, match: Optional[dict] = None) -> list:
        """(labels, child-handle) pairs for a metric name, optionally
        filtered to label sets containing every pair of ``match``."""
        with self._lock:
            fam = list((self._children.get(name) or {}).values())
        if match:
            want = {(str(k), str(v)) for k, v in match.items()}
            fam = [p for p in fam if want <= set(p.labels.items())]
        return [(dict(p.labels), p) for p in fam]

    def labeled(self) -> dict:
        """Every labeled child's stats, keyed by parent name — the
        dimensional companion of ``snapshot()`` (which stays
        byte-identical to its pre-label schema): ``{name: [(labels,
        {"type": ..., ...stats}), ...]}`` sorted by name and label
        set."""
        with self._lock:
            fams = {n: dict(f) for n, f in self._children.items() if f}
        out: dict = {}
        for name in sorted(fams):
            out[name] = [(dict(k), fams[name][k].stats())
                         for k in sorted(fams[name])]
        return out

    def gauge_counters(self) -> set:
        """Names of counters flagged ``gauge=True`` (bidirectional) —
        the exposition types these as gauges."""
        with self._lock:
            return {n for n, c in self._counters.items() if c.gauge}

    def gauge_snapshot(self) -> dict:
        """``{name: {"value": parent read, "own": bool, "children":
        [(labels, value)]}}`` — gauges are views, not accumulations, so
        they live outside ``snapshot()``. ``own`` marks a parent with
        its OWN callback: when False and children exist, ``value`` is
        the sum-of-children roll-up — fine for additive families (HBM
        bytes) but meaningless for ratios (burn rates), so the
        Prometheus exposition only emits the parent sample when it is
        ``own`` or childless."""
        with self._lock:
            names = sorted(set(self._gauges) | set(self._gauge_children))
            fams = {n: dict(self._gauge_children.get(n) or {})
                    for n in names}
            parents = {n: self._gauges.get(n) for n in names}
        out: dict = {}
        for n in names:
            # each callback runs ONCE per scrape: the children reads
            # feed both the child samples and (for a callback-less
            # parent) the roll-up sum
            kids = [(dict(k), fams[n][k].read()) for k in sorted(fams[n])]
            p = parents[n]
            own = p is not None and p.fn is not None
            if own or not kids:
                value = p.read() if p is not None else 0.0
            else:
                value = sum(v for _k, v in kids)
            out[n] = {"value": value, "own": own, "children": kids}
        return out

    def histogram_stats(self, name: str) -> Optional[dict]:
        """Non-creating histogram read: ``to_dict()`` or None when the
        name was never recorded. Signal READERS (the autotune
        controller, diagnostics) use this instead of ``histogram()`` —
        observation must not mint registry entries as a side effect,
        or a shadow-mode observer would perturb the very snapshot it
        is compared against."""
        h = self._histograms.get(name)
        return h.to_dict() if h is not None else None

    def timer_count(self, name: str) -> int:
        t = self._timers.get(name)
        return t.count if t is not None else 0

    def snapshot(self) -> dict:
        """One schema across all three metric kinds: each entry is a dict with
        ``type`` (counter | timer | histogram) and ``count``, plus the
        kind's stats (timers in ms, histograms in their raw unit) —
        the reporter/exporter payload."""
        # the lists are taken under the lock that guards insertion: a
        # reporter thread snapshots while the graph's threads add names
        with self._lock:
            counters = sorted(self._counters.items())
            timers = sorted(self._timers.items())
            histograms = sorted(self._histograms.items())
        out: dict = {}
        for name, c in counters:
            out[name] = {"type": "counter", "count": c.count}
        for name, t in timers:
            out[name] = {"type": "timer", "count": t.count,
                         "mean_ms": t.mean_ns / 1e6,
                         "min_ms": t.min_ns / 1e6,
                         "max_ms": t.max_ns / 1e6,
                         "total_ms": t.total_ns / 1e6}
        for name, h in histograms:
            out[name] = {"type": "histogram", **h.to_dict()}
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._histograms.clear()
            self._children.clear()
            self._gauges.clear()
            self._gauge_children.clear()

    # -- reporters (reference: console/CSV reporters,
    #    GraphDatabaseConfiguration.java:1010-1226) --------------------------

    def report_console(self, out=None) -> str:
        buf = io.StringIO()
        for name, val in self.snapshot().items():
            kind = val["type"]
            if kind == "timer":
                buf.write(f"{name}: count={val['count']} "
                          f"mean={val['mean_ms']:.3f}ms max={val['max_ms']:.3f}ms\n")
            elif kind == "histogram":
                buf.write(f"{name}: count={val['count']} "
                          f"p50={val['p50']:.3f} p95={val['p95']:.3f} "
                          f"max={val['max']:.3f}\n")
            else:
                buf.write(f"{name}: {val['count']}\n")
        text = buf.getvalue()
        if out is not None:
            out.write(text)
        return text

    #: the ONE report_csv header, stable across all three metric kinds
    CSV_HEADER = ("metric", "type", "count", "mean", "min", "max",
                  "p50", "p95")

    def report_csv(self, path: str) -> None:
        """One row per metric under ``CSV_HEADER``; timer stats are in
        ms (as the snapshot reports them), histograms in their raw
        unit, counter rows leave the stat columns empty."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(self.CSV_HEADER)
            for name, val in self.snapshot().items():
                kind = val["type"]
                if kind == "timer":
                    w.writerow([name, kind, val["count"],
                                f"{val['mean_ms']:.6f}",
                                f"{val['min_ms']:.6f}",
                                f"{val['max_ms']:.6f}", "", ""])
                elif kind == "histogram":
                    w.writerow([name, kind, val["count"],
                                f"{val['mean']:.6f}", f"{val['min']:.6f}",
                                f"{val['max']:.6f}", f"{val['p50']:.6f}",
                                f"{val['p95']:.6f}"])
                else:
                    w.writerow([name, kind, val["count"],
                                "", "", "", "", ""])


# live reporters keyed by (manager identity, sink identity): two graphs
# opened with the same reporter config over the process-global registry
# SHARE one reporter thread instead of each emitting the full shared
# snapshot (duplicate console/CSV/Graphite streams); the
# shared reporter is refcounted so closing one graph doesn't silence
# the other. Entries are evicted on final stop (under the lock) so
# long-lived servers cycling graph opens don't pin dead reporters.
_ACTIVE_REPORTERS: dict = {}
_ACTIVE_LOCK = threading.Lock()


class ScheduledReporter:
    """Background daemon thread that emits a metrics snapshot every
    ``interval_s`` seconds (reference: the Dropwizard scheduled
    reporters configured per namespace —
    GraphDatabaseConfiguration.java:1010-1226). ``emit`` receives
    (manager, timestamp); exceptions are swallowed after counting
    (a dead sink must not take the graph down)."""

    def __init__(self, manager: "MetricManager", interval_s: float,
                 emit, name: str = "reporter"):
        self.manager = manager
        self.interval_s = interval_s
        self.emit = emit
        self.name = name
        self.errors = 0
        self.reports = 0
        # shared-reporter refcount: start_reporters dedups per
        # (manager, sink) and hands the SAME reporter to every graph
        # that asked for it; each graph's close() calls stop(), and
        # only the LAST stop actually ends the thread. _dedup_key is
        # set by _shared_reporter so the registry entry is evicted on
        # final stop; refcount moves happen under _ACTIVE_LOCK (the
        # same lock _shared_reporter joins under)
        self._refs = 1
        self._dedup_key = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"metrics-{name}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.report_now()

    def report_now(self) -> None:
        # a report requested AFTER stop is a no-op: stop() may race an
        # in-flight emit (which finishes and counts), but a post-stop
        # call must not double-report to a sink the owner already
        # considers closed (tests/test_metrics.py pins this race)
        if self._stop.is_set():
            return
        try:
            self.emit(self.manager, time.time())
            self.reports += 1
        except Exception:
            self.errors += 1

    def stop(self, timeout: float = 5.0) -> None:
        """Release one acquisition; the last release ends the thread.
        Call EXACTLY ONCE per start_reporters acquisition while shared
        (graph.close guards this with its _open flag); once the thread
        is fully stopped, further stops are idempotent no-ops."""
        with _ACTIVE_LOCK:
            if self._stop.is_set():
                return
            self._refs -= 1
            if self._refs > 0:
                return
            self._stop.set()
            if self._dedup_key is not None and \
                    _ACTIVE_REPORTERS.get(self._dedup_key) is self:
                del _ACTIVE_REPORTERS[self._dedup_key]
        self._thread.join(timeout)

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()


def _console_emit(stream=None):
    def emit(manager, ts):
        out = stream or sys.stderr
        out.write(f"== metrics @ {ts:.0f} ==\n")
        manager.report_console(out)
    return emit


def _csv_emit(directory: str):
    def emit(manager, ts):
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "metrics.csv")
        fresh = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.writer(f)
            if fresh:
                w.writerow(["timestamp", "metric", "count", "mean_ms",
                            "min_ms", "max_ms"])
            for name, val in manager.snapshot().items():
                if val["type"] == "counter":
                    w.writerow([f"{ts:.3f}", name, val["count"],
                                "", "", ""])
                else:
                    mean = val.get("mean_ms", val.get("mean", 0.0))
                    lo = val.get("min_ms", val.get("min", 0.0))
                    hi = val.get("max_ms", val.get("max", 0.0))
                    w.writerow([f"{ts:.3f}", name, val["count"],
                                f"{mean:.6f}", f"{lo:.6f}", f"{hi:.6f}"])
    return emit


def _graphite_emit(host: str, port: int, prefix: str):
    def emit(manager, ts):
        import socket

        lines = []
        t = int(ts)
        for name, val in manager.snapshot().items():
            key = f"{prefix}.{name}".replace(" ", "_")
            if val["type"] == "timer":
                lines.append(f"{key}.count {val['count']} {t}\n")
                lines.append(f"{key}.mean_ms {val['mean_ms']:.6f} {t}\n")
                lines.append(f"{key}.max_ms {val['max_ms']:.6f} {t}\n")
            elif val["type"] == "histogram":
                lines.append(f"{key}.count {val['count']} {t}\n")
                lines.append(f"{key}.p50 {val['p50']:.6f} {t}\n")
                lines.append(f"{key}.p95 {val['p95']:.6f} {t}\n")
            else:
                lines.append(f"{key} {val['count']} {t}\n")
        with socket.create_connection((host, port), timeout=5.0) as s:
            s.sendall("".join(lines).encode())
    return emit


def _shared_reporter(key, make) -> ScheduledReporter:
    with _ACTIVE_LOCK:
        r = _ACTIVE_REPORTERS.get(key)
        if r is not None and not r.stopped:
            r._refs += 1
            return r
        r = make()
        r._dedup_key = key
        _ACTIVE_REPORTERS[key] = r
        return r


def start_reporters(config, manager: Optional["MetricManager"] = None
                    ) -> list[ScheduledReporter]:
    """Start every reporter whose interval option is > 0 (the graph
    calls this at open and stops them at close). Startup is deduped per
    (manager, sink): a second graph with an identical sink config joins
    the running reporter's refcount instead of spawning a duplicate
    stream."""
    from titan_tpu_torch.config import defaults as d

    manager = manager or MetricManager.instance()
    prefix = config.get(d.METRICS_PREFIX)
    out: list[ScheduledReporter] = []
    iv = config.get(d.METRICS_CONSOLE_INTERVAL)
    if iv > 0:
        out.append(_shared_reporter(
            (id(manager), "console", iv),
            lambda: ScheduledReporter(manager, iv, _console_emit(),
                                      "console")))
    iv = config.get(d.METRICS_CSV_INTERVAL)
    if iv > 0:
        csv_dir = config.get(d.METRICS_CSV_DIR)
        out.append(_shared_reporter(
            (id(manager), "csv", iv, csv_dir),
            lambda: ScheduledReporter(manager, iv, _csv_emit(csv_dir),
                                      "csv")))
    iv = config.get(d.METRICS_GRAPHITE_INTERVAL)
    if iv > 0:
        host = config.get(d.METRICS_GRAPHITE_HOST)
        port = config.get(d.METRICS_GRAPHITE_PORT)
        out.append(_shared_reporter(
            (id(manager), "graphite", iv, host, port, prefix),
            lambda: ScheduledReporter(
                manager, iv, _graphite_emit(host, port, prefix),
                "graphite")))
    return out


class _OpRecorder:
    __slots__ = ("_timer", "_calls", "_fails", "_t0")

    def __init__(self, metrics: MetricManager, prefix: str, store: str, op: str):
        base = f"{prefix}.{store}.{op}"
        self._timer = metrics.timer(f"{base}.{M_TIME}")
        self._calls = metrics.counter(f"{base}.{M_CALLS}")
        self._fails = metrics.counter(f"{base}.{M_EXCEPTIONS}")
        self._t0 = 0

    def __enter__(self):
        self._calls.inc()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._timer.update(time.perf_counter_ns() - self._t0)
        if exc_type is not None:
            self._fails.inc()
        return False


class MetricInstrumentedStore(KeyColumnValueStore):
    """Wraps every store op in calls/time/exceptions metrics under both the
    store's own name and the merged name (reference:
    diskstorage/util/MetricInstrumentedStore.java)."""

    def __init__(self, store: KeyColumnValueStore, prefix: str,
                 metrics: Optional[MetricManager] = None,
                 merged_name: Optional[str] = None):
        self._store = store
        self._prefix = prefix
        self._metrics = metrics or MetricManager.instance()
        self._merged = merged_name

    @property
    def name(self) -> str:
        return self._store.name

    @property
    def wrapped(self) -> KeyColumnValueStore:
        return self._store

    def _rec(self, op: str):
        return _OpRecorder(self._metrics, self._prefix,
                           self._merged or self._store.name, op)

    def get_slice(self, query: KeySliceQuery, txh: StoreTransaction):
        with self._rec("getSlice"):
            result = self._store.get_slice(query, txh)
        self._metrics.counter(
            f"{self._prefix}.{self._merged or self._store.name}"
            f".getSlice.{M_ENTRIES_COUNT}").inc(len(result))
        return result

    def get_slice_multi(self, keys: Sequence[bytes], slice_query: SliceQuery,
                        txh: StoreTransaction) -> dict:
        with self._rec("getSliceMulti"):
            return self._store.get_slice_multi(keys, slice_query, txh)

    def mutate(self, key: bytes, additions: Sequence[Entry],
               deletions: Sequence[bytes], txh: StoreTransaction) -> None:
        with self._rec("mutate"):
            self._store.mutate(key, additions, deletions, txh)

    def acquire_lock(self, key: bytes, column: bytes, expected: Optional[bytes],
                     txh: StoreTransaction) -> None:
        with self._rec("acquireLock"):
            self._store.acquire_lock(key, column, expected, txh)

    def get_keys(self, query, txh: StoreTransaction) -> Iterator:
        with self._rec("getKeys"):
            it = self._store.get_keys(query, txh)
        return it

    def close(self) -> None:
        self._store.close()


class MetricInstrumentedStoreManager(KeyColumnValueStoreManager):
    """Wraps opened stores + mutate_many (reference:
    diskstorage/util/MetricInstrumentedStoreManager.java; merged-store
    naming per Backend.java:83-86)."""

    def __init__(self, manager: KeyColumnValueStoreManager, prefix: str,
                 metrics: Optional[MetricManager] = None,
                 merge_stores: bool = True):
        self._manager = manager
        self._prefix = prefix
        self._metrics = metrics or MetricManager.instance()
        self._merge = merge_stores

    @property
    def name(self) -> str:
        return self._manager.name

    @property
    def features(self):
        return self._manager.features

    @property
    def wrapped(self) -> KeyColumnValueStoreManager:
        return self._manager

    def open_database(self, name: str) -> KeyColumnValueStore:
        store = self._manager.open_database(name)
        merged = MERGED_STORE if self._merge else None
        return MetricInstrumentedStore(store, self._prefix, self._metrics,
                                       merged_name=merged)

    def begin_transaction(self, config=None) -> StoreTransaction:
        return self._manager.begin_transaction(config)

    def mutate_many(self, mutations: dict, txh: StoreTransaction) -> None:
        # unwrap: the inner manager must see its own stores
        with _OpRecorder(self._metrics, self._prefix,
                         MERGED_STORE if self._merge else self._manager.name,
                         "mutateMany"):
            self._manager.mutate_many(mutations, txh)

    def get_local_key_partition(self):
        return self._manager.get_local_key_partition()

    def close(self) -> None:
        self._manager.close()

    def clear_storage(self) -> None:
        self._manager.clear_storage()

    def exists(self) -> bool:
        return self._manager.exists()
