"""A short ``torch.profiler`` slice of the measured window, read back into
the device's busy time, its operations by name, and its idle gaps.

The card's activity (kernels, copies, memsets) is taken from the
profiler's trace, whichever thread launched it. The slice is the
profiler's own active span (its ``Trace`` event), and every event is
placed on the host's wall clock by that span's start, so the idle gaps
can be named by what the system under test's spans say the host was
doing then. A process's first profiler session can start recording the
card late and place its events seconds off (seen on an H100 under
PyTorch 2.11), so ``warm_up`` runs one short session during set-up.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

#: device activity in a Kineto trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: entries of each breakdown list
TOP = 10


def warm_up(device) -> None:
    """One short profiler session over a small CUDA operation, so that the
    measured slice is not the process's first."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(10):
            x.mul_(1.0)
        torch.cuda.synchronize(device)
        time.sleep(0.2)


class Slice:
    """``with Slice(): ...`` profiles the block; afterwards ``busy_s``,
    ``window_s``, ``intervals`` (merged, wall clock), ``ops`` (seconds by
    name) and ``runtime`` (the host's CUDA calls) hold what it saw."""

    def __init__(self):
        self.t0 = self.t1 = None
        self.busy_s = 0.0
        self.window_s = 0.0
        self.intervals: list = []
        self.ops: dict = {}
        self.runtime: list = []
        self.seen: dict = {}          # trace events by category
        self.device_span = None      # first and last device event
        self.trace_span = None       # the profiler's own active span
        self._prof = None

    def __enter__(self) -> "Slice":
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.time()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self.t1 = time.time()
        self._prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="gbench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        self._read(trace)

    def _read(self, trace: dict) -> None:
        base = float(trace.get("baseTimeNanoseconds", 0)) / 1e9
        events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
        for e in events:
            if e.get("cat") == "Trace":
                a = base + float(e["ts"]) / 1e6
                self.trace_span = (a, a + float(e["dur"]) / 1e6)
        # the profiler's active span is the slice, placed at its host start
        shift = 0.0
        if self.trace_span is not None:
            shift = self.t0 - self.trace_span[0]
            self.t1 = self.t0 + (self.trace_span[1] - self.trace_span[0])
        spans = []
        for e in events:
            a = base + float(e["ts"]) / 1e6 + shift
            b = a + float(e["dur"]) / 1e6
            cat = e.get("cat")
            self.seen[cat] = self.seen.get(cat, 0) + 1
            if cat in DEVICE_CATS:
                lo, hi = self.device_span or (a, b)
                self.device_span = (min(lo, a), max(hi, b))
                a, b = max(a, self.t0), min(b, self.t1)
                if b > a:
                    spans.append((a, b))
                    name = str(e.get("name", cat))[:120]
                    self.ops[name] = self.ops.get(name, 0.0) + (b - a)
            elif cat == "cuda_runtime":
                self.runtime.append((a, b, str(e.get("name"))))
        spans.sort()
        merged: list = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.intervals = merged
        self.busy_s = sum(b - a for a, b in merged)
        self.window_s = self.t1 - self.t0
        self.runtime.sort()

    def describe(self) -> str:
        """One line on what the trace held, for standard error."""
        span = "none" if self.device_span is None else \
            (f"{self.device_span[0] - self.t0:+.3f} s to "
             f"{self.device_span[1] - self.t1:+.3f} s")
        tspan = "none" if self.trace_span is None else \
            (f"{self.trace_span[1] - self.trace_span[0]:.3f} s, placed "
             f"{self.t0 - self.trace_span[0]:+.3f} s from the trace's "
             f"own clock")
        return (f"profiled slice {self.window_s:.3f} s, device busy "
                f"{self.busy_s:.3f} s; events by category {self.seen}; "
                f"device events from the slice's start and to its end: "
                f"{span}; the profiler's span {tspan}")

    def gaps(self) -> list:
        """The idle gaps ``(start, seconds)``, longest first."""
        out = []
        prev = self.t0
        for a, b in self.intervals:
            if a > prev:
                out.append((prev, a - prev))
            prev = max(prev, b)
        if self.t1 > prev:
            out.append((prev, self.t1 - prev))
        return sorted(out, key=lambda g: -g[1])

    def host_call_at(self, t: float):
        """The host's CUDA call in flight at ``t``, if any."""
        for a, b, name in self.runtime:
            if a > t:
                break
            if b >= t:
                return name
        return None

    def breakdown(self, label) -> dict:
        """The contract's ``breakdown``: the device operations that took
        most time, and the longest idle gaps, each named by
        ``label(t)``, what the host was doing at the gap's middle."""
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = []
        for start, secs in self.gaps()[:TOP]:
            mid = start + secs / 2
            call = self.host_call_at(mid)
            name = label(mid) + (f"; in {call}" if call else "")
            gaps.append([name, secs])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}
