"""Lightweight span tracer for the serving/kernel/recovery planes.

Dapper-style explicit spans: the scheduler opens a trace per job (the
trace id IS the job id), execution layers attach child spans through
the job's ``TraceHandle``, and ``GET /trace?job=<id>`` renders the tree.
Design constraints:

* **host-only** — spans are plain host timestamps taken at seams that
  already exist (round-boundary callbacks, checkpoint hooks); nothing
  here adds device collectives or syncs inside jitted code;
* **bounded** — each trace is a ring buffer of ``max_spans`` spans
  (oldest non-root spans drop first, counted in ``dropped_spans``) and
  the tracer holds at most ``max_traces`` traces (oldest evicted), so a
  long-lived server cannot leak memory through its own telemetry;
* **deterministic tests** — the clock is injectable;
* **removable** — a disabled tracer (``Tracer(enabled=False)``, or
  ``JobScheduler(tracing=False)`` / ``TITAN_TPU_TRACING=0``) returns a
  shared no-op span from every call and records nothing; execution
  layers additionally skip their hooks when ``job.trace is None``, so
  the per-round cost of tracing-off is one attribute check.

Thread-safety: journal mutation is lock-guarded; ``Span.end`` mutates
only the span object (single writer — the layer that started it).

The port's copy of ``titan_tpu/obs/tracing.py``, host code only.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Optional

#: per-call ingest/drain bound: one split response (or drain batch) may
#: splice at most this many remote spans — overflow is counted, never
#: spliced, so a chatty worker cannot evict the coordinator's local
#: spans through sheer volume (docs/observability.md "Cross-process
#: tracing")
INGEST_MAX_SPANS = 512


def make_traceparent(trace_id: str, span_id) -> str:
    """W3C-style trace context for the split wire: ``00-<trace
    id>-<parent span id>-01``. Trace ids here are job ids (arbitrary
    strings, dashes allowed), span ids are the tracer's integers — the
    four-field shape and version/flags framing follow the traceparent
    header so the field order is familiar, not byte-compatible hex."""
    return f"00-{trace_id}-{int(span_id)}-01"


def parse_traceparent(value) -> Optional[tuple]:
    """``(trace_id, parent_span_id)`` or None for anything malformed —
    a worker must degrade to untraced execution, never 500, on a bad
    header."""
    if not isinstance(value, str):
        return None
    parts = value.split("-")
    if len(parts) < 4 or parts[0] != "00" or parts[-1] != "01":
        return None
    trace_id = "-".join(parts[1:-2])
    if not trace_id:
        return None
    try:
        return trace_id, int(parts[-2])
    except ValueError:
        return None


class Span:
    """One timed operation. ``attrs`` carry the seam's payload (frontier
    size, K, checkpoint round, ...); ``parent_id`` links the tree."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t_start",
                 "t_end", "attrs")

    def __init__(self, trace_id: str, span_id: int,
                 parent_id: Optional[int], name: str, t_start: float,
                 attrs: Optional[dict]):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.attrs = attrs

    def set(self, **attrs) -> "Span":
        if attrs:
            if self.attrs is None:
                self.attrs = {}
            self.attrs.update(attrs)
        return self

    @property
    def open(self) -> bool:
        return self.t_end is None

    @property
    def duration_ms(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return (self.t_end - self.t_start) * 1e3

    def to_dict(self) -> dict:
        out = {"span": self.span_id, "name": self.name,
               "start": self.t_start, "end": self.t_end}
        if self.parent_id is not None:
            out["parent"] = self.parent_id
        d = self.duration_ms
        if d is not None:
            out["duration_ms"] = round(d, 3)
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out

    def __repr__(self) -> str:
        state = "open" if self.open else f"{self.duration_ms:.3f}ms"
        return f"<Span {self.span_id} {self.name!r} {state}>"


class _NullSpan:
    """Shared no-op span a disabled tracer hands out — every mutator is
    a no-op, so call sites never branch on enablement."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    name = None
    t_start = 0.0
    t_end = 0.0
    attrs = None
    open = False
    duration_ms = None

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _Trace:
    __slots__ = ("spans", "dropped")

    def __init__(self):
        self.spans: list[Span] = []
        self.dropped = 0

    def add(self, span: Span, cap: int) -> None:
        if len(self.spans) >= cap:
            # ring behavior: drop the oldest span, but keep the trace's
            # FIRST span (the root anchor) alive so the tree stays
            # navigable under churn
            i = 1 if len(self.spans) > 1 and \
                self.spans[0].parent_id is None else 0
            del self.spans[i]
            self.dropped += 1
        self.spans.append(span)


class Tracer:
    """Span journal keyed by trace id. One per ``JobScheduler`` (job
    ids are process-unique, so traces never collide); independently
    constructible for tests."""

    def __init__(self, clock=None, *, enabled: bool = True,
                 max_spans: int = 4096, max_traces: int = 512):
        self.clock = clock or time.time
        self.enabled = enabled
        self.max_spans = int(max_spans)
        self.max_traces = int(max_traces)
        # flight-recorder seam (obs/flightrec): a callable
        # invoked with each COMPLETED span (from end/event) so the
        # bounded ring journals the span stream; None costs one
        # attribute check per completion
        self.tap = None
        self._traces: "OrderedDict[str, _Trace]" = OrderedDict()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    # -- write side ----------------------------------------------------------

    def start(self, trace_id: str, name: str, parent=None, **attrs):
        """Open a span; ``parent`` is a Span (or span id, or None)."""
        if not self.enabled:
            return NULL_SPAN
        now = self.clock()
        parent_id = parent.span_id if isinstance(parent, (Span, _NullSpan)) \
            else parent
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                while len(self._traces) >= self.max_traces:
                    self._traces.popitem(last=False)
                tr = _Trace()
                self._traces[trace_id] = tr
            s = Span(trace_id, next(self._ids), parent_id, name, now,
                     dict(attrs) if attrs else None)
            tr.add(s, self.max_spans)
        return s

    def end(self, span, t_end: Optional[float] = None, **attrs) -> None:
        if not isinstance(span, Span) or span.t_end is not None:
            return
        span.set(**attrs)
        span.t_end = self.clock() if t_end is None else t_end
        tap = self.tap
        if tap is not None:
            tap(span)

    def event(self, trace_id: str, name: str, parent=None,
              t0: Optional[float] = None, t1: Optional[float] = None,
              **attrs):
        """Record a COMPLETED span with explicit host timestamps — the
        retroactive form the per-round seams use (the wall time was
        measured by the kernel's own boundary callbacks)."""
        if not self.enabled:
            return NULL_SPAN
        now = self.clock()
        s = self.start(trace_id, name, parent=parent, **attrs)
        # (t0, t1) given → explicit window; t0 only → t0..now;
        # neither → an instant event stamped now
        s.t_start = now if t0 is None else t0
        if t1 is not None:
            s.t_end = t1
        else:
            s.t_end = now if t0 is not None else s.t_start
        tap = self.tap
        if tap is not None:
            tap(s)
        return s

    @contextmanager
    def span(self, trace_id: str, name: str, parent=None, **attrs):
        s = self.start(trace_id, name, parent=parent, **attrs)
        try:
            yield s
        finally:
            self.end(s)

    def discard(self, trace_id: str) -> None:
        with self._lock:
            self._traces.pop(trace_id, None)

    # -- cross-process seam ------------------------------------------------

    def drain(self, trace_id: str,
              max_spans: int = INGEST_MAX_SPANS) -> tuple:
        """Pop up to ``max_spans`` COMPLETED spans of a trace as wire
        dicts (``Span.to_dict`` shape) — the worker side of span
        shipping: completed spans ride the split response (or a
        ``/trace/drain`` poll) exactly once, open spans stay journaled
        for a later drain. Returns ``(wire_spans, dropped)`` where
        ``dropped`` is the trace's ring-drop count; an empty trace is
        garbage-collected so fire-and-forget workers don't accumulate
        dead trace keys."""
        cap = max(0, int(max_spans))
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                return [], 0
            take = [s for s in tr.spans if s.t_end is not None][:cap]
            taken = {id(s) for s in take}
            tr.spans = [s for s in tr.spans if id(s) not in taken]
            dropped = tr.dropped
            if not tr.spans:
                del self._traces[trace_id]
        return [s.to_dict() for s in take], dropped

    def ingest(self, trace_id: str, spans, *, parent_id=None,
               offset: float = 0.0, window=None, instance=None,
               extra_dropped: int = 0, metrics=None,
               max_spans: int = INGEST_MAX_SPANS) -> int:
        """Splice remote COMPLETED spans (wire dicts from :meth:`drain`)
        into the owning trace; returns the number accepted.

        * **id remap** — remote span ids come from the remote tracer's
          own counter (same ``count(1)`` as ours, so they collide
          numerically); every shipped id is remapped to a fresh local
          id, parent links inside the batch follow the map, and a span
          whose parent was NOT shipped (the remote root, or a child
          orphaned by the remote ring) attaches under ``parent_id`` —
          the coordinator's split span — so the stitched tree never
          dangles.
        * **clock-skew normalization** — ``offset`` (remote→local
          seconds, NTP-style from the request send/receive anchors) is
          added to every timestamp; with a ``window=(lo, hi)`` the
          result is additionally clamped into the coordinator's
          send/receive envelope (clamps counted), so child timestamps
          stay monotonic under the split span even when the skew
          estimate is off.
        * **bounds** — at most ``max_spans`` per call (overflow counted,
          plus the remote's own ``extra_dropped``), and splicing goes
          through the same per-trace ring as local spans, so a chatty
          worker cannot evict the local root.

        Counters (when ``metrics`` is given): ``obs.ingest.spans`` /
        ``obs.ingest.dropped`` / ``obs.ingest.clamped``. Each accepted
        span is marked ``remote=True`` + ``instance`` and fed to the
        flight-recorder ``tap`` like any locally completed span."""
        batch = list(spans or [])
        dropped = max(0, int(extra_dropped))
        if not self.enabled:
            if metrics is not None and (batch or dropped):
                metrics.counter("obs.ingest.dropped").inc(
                    len(batch) + dropped)
            return 0
        cap = max(0, int(max_spans))
        dropped += max(0, len(batch) - cap)
        batch = batch[:cap]
        clamped = 0
        lo, hi = window if window is not None else (None, None)
        idmap: dict = {}
        parsed = []
        for w in batch:
            try:
                rid = int(w["span"])
                t0 = float(w["start"]) + float(offset)
                t1 = float(w["end"]) + float(offset)
            except (KeyError, TypeError, ValueError):
                dropped += 1
                continue
            if lo is not None:
                c0 = min(max(t0, lo), hi)
                c1 = min(max(t1, lo), hi)
                if c0 != t0 or c1 != t1:
                    clamped += 1
                t0, t1 = c0, c1
            idmap[rid] = next(self._ids)
            parsed.append((rid, w, t0, t1))
        accepted = []
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                while len(self._traces) >= self.max_traces:
                    self._traces.popitem(last=False)
                tr = _Trace()
                self._traces[trace_id] = tr
            for rid, w, t0, t1 in parsed:
                attrs = dict(w.get("attrs") or {})
                attrs["remote"] = True
                if instance is not None:
                    attrs["instance"] = instance
                s = Span(trace_id, idmap[rid],
                         idmap.get(w.get("parent"), parent_id),
                         str(w.get("name", "remote")), t0, attrs)
                s.t_end = t1
                tr.add(s, self.max_spans)
                accepted.append(s)
        tap = self.tap
        if tap is not None:
            for s in accepted:
                tap(s)
        if metrics is not None:
            if accepted:
                metrics.counter("obs.ingest.spans").inc(len(accepted))
            if dropped:
                metrics.counter("obs.ingest.dropped").inc(dropped)
            if clamped:
                metrics.counter("obs.ingest.clamped").inc(clamped)
        return len(accepted)

    # -- read side -----------------------------------------------------------

    def spans(self, trace_id: str) -> Optional[list]:
        """Journal snapshot (insertion order), or None for an unknown
        trace."""
        with self._lock:
            tr = self._traces.get(trace_id)
            return list(tr.spans) if tr is not None else None

    def dropped(self, trace_id: str) -> int:
        with self._lock:
            tr = self._traces.get(trace_id)
            return tr.dropped if tr is not None else 0

    def tree(self, trace_id: str) -> Optional[dict]:
        """JSON span tree: ``{"trace", "dropped_spans", "spans":
        [nested]}``; spans whose parent was ring-dropped surface as
        roots (the tree must stay renderable under churn)."""
        spans = self.spans(trace_id)
        if spans is None:
            return None
        nodes = {s.span_id: {**s.to_dict(), "children": []}
                 for s in spans}
        roots: list = []
        for s in spans:
            node = nodes[s.span_id]
            parent = nodes.get(s.parent_id)
            (parent["children"] if parent is not None else roots
             ).append(node)
        return {"trace": trace_id, "dropped_spans": self.dropped(trace_id),
                "spans": roots}


class TraceHandle:
    """What execution layers hold: (tracer, trace id, current parents).
    The scheduler attaches one per job (``job.trace``) when tracing is
    enabled — batcher/recovery/kernel hooks test ``job.trace is None``
    and skip entirely when it is, so a disabled tracer costs one
    attribute read per seam."""

    __slots__ = ("tracer", "trace_id", "root", "queue", "attempt")

    def __init__(self, tracer: Tracer, trace_id: str, root: Span):
        self.tracer = tracer
        self.trace_id = trace_id
        self.root = root
        self.queue: Optional[Span] = None    # submit → first start
        self.attempt: Optional[Span] = None  # current attempt span

    @property
    def parent(self):
        """Default parent for execution spans: the in-flight attempt,
        else the root."""
        return self.attempt if self.attempt is not None else self.root

    def start(self, name: str, parent=None, **attrs):
        return self.tracer.start(self.trace_id, name,
                                 parent=self.parent if parent is None
                                 else parent, **attrs)

    def end(self, span, **attrs) -> None:
        self.tracer.end(span, **attrs)

    def event(self, name: str, parent=None, t0=None, t1=None, **attrs):
        return self.tracer.event(self.trace_id, name,
                                 parent=self.parent if parent is None
                                 else parent, t0=t0, t1=t1, **attrs)


def trace_summary(tracer: Optional[Tracer], trace_id: str
                  ) -> Optional[dict]:
    """The ``GET /jobs`` digest of a job's trace: where the time went
    (queue / fuse / device) plus the round count — computed from the
    journal, None when the trace doesn't exist (tracing disabled /
    evicted)."""
    if tracer is None:
        return None
    spans = tracer.spans(trace_id)
    if not spans:
        return None
    out: dict = {"spans": len(spans)}
    rounds = 0
    device_ms = 0.0
    have_device = False
    for s in spans:
        d = s.duration_ms
        if s.name == "queue" and d is not None:
            out["queue_ms"] = round(d, 3)
        elif s.name == "fuse" and d is not None:
            out["fuse_ms"] = round(d, 3)
        elif s.name == "run" and d is not None:
            device_ms += d
            have_device = True
        elif s.name == "round":
            rounds += 1
    if have_device:
        out["device_ms"] = round(device_ms, 3)
    out["rounds"] = rounds
    return out
