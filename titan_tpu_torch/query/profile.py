"""Query profiler: tree-structured timers + annotations.

(reference: titan-core graphdb/query/profile/QueryProfiler.java — a tree of
timed groups with key/value annotations threaded through every query
(StandardTitanTx.java:1030,1116,1247); surfaced in Gremlin ``.profile()``
via graphdb/tinkerpop/profile/TP3ProfileWrapper.java. The rebuild keeps the
same shape: ``QueryProfiler`` nodes nest via ``group()``, annotate with
``annotate()``, and render as an indented tree; traversal ``.profile()``
returns per-step ``TraversalMetrics``.)

The port's copy of ``titan_tpu/query/profile.py``.
"""

from __future__ import annotations

import time
from typing import Any, Optional

AND_QUERY = "AND-query"
OR_QUERY = "OR-query"
OPTIMIZATION = "optimization"
BACKEND_QUERY = "backend-query"
FULL_SCAN = "full-scan"


class QueryProfiler:
    """One profiled group. Use as a context manager to time it:

        with profiler.group("backend-query") as p:
            p.annotate("query", q)
            ...
    """

    def __init__(self, name: str = "root"):
        self.name = name
        self.annotations: dict[str, Any] = {}
        self.children: list[QueryProfiler] = []
        self.time_ns = 0
        self._t0: Optional[int] = None

    # -- structure -----------------------------------------------------------

    def group(self, name: str) -> "QueryProfiler":
        child = QueryProfiler(name)
        self.children.append(child)
        return child

    def annotate(self, key: str, value: Any) -> "QueryProfiler":
        self.annotations[key] = value
        return self

    # -- timing --------------------------------------------------------------

    def __enter__(self) -> "QueryProfiler":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._t0 is not None:
            self.time_ns += time.perf_counter_ns() - self._t0
            self._t0 = None
        return False

    @property
    def time_ms(self) -> float:
        return self.time_ns / 1e6

    # -- reporting -----------------------------------------------------------

    def to_dict(self) -> dict:
        return {"name": self.name, "time_ms": self.time_ms,
                "annotations": dict(self.annotations),
                "children": [c.to_dict() for c in self.children]}

    def render(self, indent: int = 0) -> str:
        pad = "  " * indent
        ann = " ".join(f"{k}={v}" for k, v in self.annotations.items())
        lines = [f"{pad}{self.name} [{self.time_ms:.3f}ms]"
                 + (f" {ann}" if ann else "")]
        for c in self.children:
            lines.append(c.render(indent + 1))
        return "\n".join(lines)

    def __repr__(self):
        return f"QueryProfiler({self.name}, {self.time_ms:.3f}ms, " \
               f"{len(self.children)} children)"


class _NoOpProfiler(QueryProfiler):
    """Shared do-nothing profiler; all paths thread it by default so
    profiling costs nothing when off (reference: QueryProfiler.NO_OP)."""

    def __init__(self):
        super().__init__("no-op")

    def group(self, name: str) -> "QueryProfiler":
        return self

    def annotate(self, key: str, value: Any) -> "QueryProfiler":
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_OP = _NoOpProfiler()


class StepMetrics:
    __slots__ = ("name", "count", "time_ns", "own_ns")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.time_ns = 0
        self.own_ns = 0


class TraversalMetrics:
    """Per-step timing/count table returned by ``traversal.profile()``
    (reference: TP3ProfileWrapper → TinkerPop TraversalMetrics)."""

    def __init__(self, steps: list[StepMetrics], total_ns: int,
                 compiled: bool = False):
        self.steps = steps
        self.total_ns = total_ns
        self.compiled = compiled

    @property
    def total_ms(self) -> float:
        return self.total_ns / 1e6

    def render(self) -> str:
        header = f"{'step':<32}{'traversers':>12}{'time(ms)':>12}{'%':>8}"
        lines = [header, "-" * len(header)]
        for s in self.steps:
            pct = 100.0 * s.own_ns / self.total_ns if self.total_ns else 0.0
            lines.append(f"{s.name:<32}{s.count:>12}"
                         f"{s.own_ns / 1e6:>12.3f}{pct:>8.2f}")
        lines.append("-" * len(header))
        lines.append(f"{'TOTAL':<32}{'':>12}{self.total_ns / 1e6:>12.3f}"
                     f"{100.0 if self.total_ns else 0.0:>8.2f}")
        if self.compiled:
            lines.append("(executed as a compiled OLAP superstep program)")
        return "\n".join(lines)

    def __repr__(self):
        return f"TraversalMetrics({len(self.steps)} steps, " \
               f"{self.total_ms:.3f}ms)"


class TimedStage:
    """Iterator wrapper accumulating pull time + traverser count for one
    step of the interpreter pipeline. Own time = this stage's pull time
    minus the upstream stage's (they nest, since pulling here drives the
    whole upstream chain)."""

    def __init__(self, inner, metrics: StepMetrics,
                 upstream: Optional["TimedStage"]):
        self._inner = iter(inner)
        self.metrics = metrics
        self._upstream = upstream

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter_ns()
        try:
            item = next(self._inner)
        finally:
            self.metrics.time_ns += time.perf_counter_ns() - t0
        self.metrics.count += 1
        return item

    def finalize(self) -> None:
        up = self._upstream.metrics.time_ns if self._upstream else 0
        self.metrics.own_ns = max(0, self.metrics.time_ns - up)
