"""Flight recorder: a bounded ring of recent events + postmortem dumps.

The tracing plane (obs/tracing) answers "what did job X do" while its
trace is still resident; this module answers "what was the WHOLE system
doing just before things went wrong" — after the fact, from disk,
without a live process to query:

* a bounded ring (``capacity`` events, oldest dropped) continuously
  journals completed spans (tapped off the Tracer — round-mass tuples
  ride in round-span attrs), device/compile events (tapped off the
  DeviceCostProfiler), transfer events and counter deltas, at one lock
  + deque append per event;
* on job FAILED / TIMEOUT / a mid-flight kill (CANCELLED while
  running) / the first RETRYING transition — or on demand via
  ``POST /debug/dump`` — :meth:`dump` writes a self-contained JSON
  bundle (span tree, last-N rounds, device events, compile log,
  metrics snapshot, ledger/pool/scheduler state, config) to the dump
  directory with an atomic rename;
* ``GET /debug/dumps`` serves :meth:`index`, and a job's
  ``GET /jobs/<id>`` envelope carries the bundle path
  (``postmortem``).

Metrics: ``flightrec.ring.events`` (appends), ``flightrec.dump.written``
/ ``flightrec.dump.errors``. The recorder is attached per scheduler via
``JobScheduler(flight_dir=...)`` (or ``TITAN_TPU_FLIGHT_DIR``); with no
dump directory configured the plane does not exist — no ring, no taps,
no files.

The port's copy of ``titan_tpu/obs/flightrec.py``, host code only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

from titan_tpu_torch.utils.metrics import MetricManager

#: bundle schema tag — bump on incompatible layout changes
BUNDLE_FORMAT = "titan-tpu-postmortem-v1"


def _json_default(obj):
    """Dump-side safety net: numpy scalars/arrays and anything else
    non-JSON render as strings — a postmortem writer must never throw
    on an exotic attr value."""
    try:
        import numpy as np
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist() if obj.size <= 64 else \
                f"<ndarray {obj.shape} {obj.dtype}>"
    except Exception:
        pass
    return str(obj)


class FlightRecorder:
    """One ring + one dump directory (per scheduler)."""

    def __init__(self, dump_dir: str, capacity: int = 4096,
                 metrics: Optional[MetricManager] = None, clock=None,
                 max_rounds_in_dump: int = 64):
        self.dump_dir = str(dump_dir)
        self.capacity = int(capacity)
        self.max_rounds_in_dump = int(max_rounds_in_dump)
        self.clock = clock or time.time
        self._metrics = metrics or MetricManager.instance()
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        # baseline = NOW: counter totals accumulated before the
        # recorder existed (a prior scheduler on the same registry)
        # must not surface as the first batch's "movement"
        self._last_counters: dict = {
            n: v["count"] for n, v in self._metrics.snapshot().items()
            if v["type"] == "counter"}
        os.makedirs(self.dump_dir, exist_ok=True)

    # -- ring ----------------------------------------------------------------

    def record(self, kind: str, **payload) -> None:
        """Append one event; O(1), oldest dropped past capacity."""
        evt = {"t": self.clock(), "kind": kind, **payload}
        with self._lock:
            self._ring.append(evt)
        self._metrics.counter("flightrec.ring.events").inc()

    def span_tap(self, span) -> None:
        """Tracer tap: journal a COMPLETED span (obs/tracing calls this
        from ``end``/``event`` when the recorder is attached). Round
        spans carry the round-mass tuple attrs (frontier, chunk_mass,
        plan_ms, band) the kernels already read back."""
        self.record("span", trace=span.trace_id, name=span.name,
                    start=span.t_start, end=span.t_end,
                    **({"attrs": dict(span.attrs)} if span.attrs
                       else {}))

    def metric_delta(self) -> None:
        """Journal the counter movement since the last call (one compact
        event per executed batch — the scheduler calls this at batch
        boundaries, so the ring shows metric flow over time)."""
        snap = self._metrics.snapshot()
        # the recorder's own counters are excluded — ring appends bump
        # flightrec.ring.events, so including them would make EVERY
        # delta nonzero (a self-perpetuating event per call)
        now = {n: v["count"] for n, v in snap.items()
               if v["type"] == "counter"
               and not n.startswith("flightrec.")}
        with self._lock:
            last = self._last_counters
            delta = {n: c - last.get(n, 0) for n, c in now.items()
                     if c != last.get(n, 0)}
            self._last_counters = now
        if delta:
            self.record("metrics", delta=delta)

    def events(self, kind: Optional[str] = None) -> list:
        """Ring snapshot (oldest first), optionally filtered by kind."""
        with self._lock:
            evts = list(self._ring)
        if kind is not None:
            evts = [e for e in evts if e["kind"] == kind]
        return evts

    # -- dumps ---------------------------------------------------------------

    def dump(self, *, reason: str, job: Optional[dict] = None,
             span_tree: Optional[dict] = None,
             state: Optional[dict] = None,
             config: Optional[dict] = None, profiler=None) -> str:
        """Write one self-contained postmortem bundle; returns its
        path. Raises only for unwritable storage (callers count
        ``flightrec.dump.errors``)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            evts = list(self._ring)
        job_id = (job or {}).get("job")
        rounds = [e for e in evts if e["kind"] == "span"
                  and e["name"] == "round"
                  and (job_id is None or e["trace"] == job_id)]
        # ingested remote spans (Tracer.ingest marks them remote +
        # instance, and feeds them through the same tap as local
        # completions) — a distributed-scan failure dumps the whole
        # cross-process tree, not just the coordinator half
        remote = [e for e in evts if e["kind"] == "span"
                  and (e.get("attrs") or {}).get("remote")
                  and (job_id is None or e["trace"] == job_id)]
        bundle = {
            "format": BUNDLE_FORMAT,
            "dumped_at": self.clock(),
            "reason": reason,
            "job": job,
            "span_tree": span_tree,
            # the last-N per-round records for THIS job (all jobs when
            # dumped without one) — the "what was it doing" section
            "rounds": rounds[-self.max_rounds_in_dump:],
            "remote_spans": remote[-self.max_rounds_in_dump:],
            "ingest_dropped": int(self._metrics.counter_value(
                "obs.ingest.dropped")),
            "device_events": [e for e in evts
                              if e["kind"] in ("device", "xfer")],
            "compile_log": profiler.compile_log()
            if profiler is not None else [],
            "device_totals": profiler.stats()
            if profiler is not None else None,
            "events": evts,
            "metrics": self._metrics.snapshot(),
            "state": state or {},
            "config": config or {},
        }
        tag = job_id or reason
        path = os.path.join(self.dump_dir,
                            f"dump-{seq:04d}-{tag}.json")
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(bundle, f, default=_json_default)
            os.replace(tmp, path)     # torn writes never become dumps
        except BaseException:
            self._metrics.counter("flightrec.dump.errors").inc()
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._metrics.counter("flightrec.dump.written").inc()
        return path

    def index(self) -> list:
        """The dump directory's bundles (``GET /debug/dumps``), newest
        first — scanned from disk so bundles from a previous process
        stay discoverable."""
        out = []
        try:
            names = os.listdir(self.dump_dir)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("dump-") and name.endswith(".json")):
                continue
            p = os.path.join(self.dump_dir, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append({"file": name, "path": p, "bytes": st.st_size,
                        "mtime": st.st_mtime})
        out.sort(key=lambda d: d["mtime"], reverse=True)
        return out
