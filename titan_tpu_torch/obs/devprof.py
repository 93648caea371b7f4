"""Device-cost profiler: build / kernel-time / transfer telemetry for the
port (the counterpart of ``titan_tpu/obs/devprof.py``, rewritten for
CUDA).

The JAX module intercepts its jit cache and XLA's compile events. The
port has neither, so it keeps the metric families and site names and
measures through four kinds of seam:

* **Kernel time**: ``profiled(key, fn, *args)`` runs ``fn`` under the
  installed profilers. The three kernel wrappers
  (``ops/frontier.frontier_round``, ``ops/frontier.batched_exhaust``,
  ``ops/seg_scan.seg_scan``) and the engine's superstep
  (``engine.superstep``) are such seams, each keyed by its kernel. On a
  CUDA tensor the call is bracketed by a pair of CUDA events on the
  current stream; nothing synchronises per call. The pairs are resolved
  (``elapsed_time``) when a ``ProfileWindow`` closes, when ``stats()`` or
  ``kernel_stats()`` is read, or, without blocking, for the finished
  ones once more than ``MAX_PENDING`` wait. On the CPU the host wall of
  the call is the time. ``with seam(key, device):`` times a block the
  same way, on ``device``'s current stream: the batched BFS's stages
  (``bfs_batched.plan``, ``.sweep``, ``.readback``) and the engine's
  (``engine.prepare``, and ``engine.gather`` / ``engine.combine``
  inside each superstep) are such seams. A seam called inside another
  (``seg_scan`` inside ``engine.combine`` inside ``engine.superstep``,
  ``frontier_round`` inside ``bfs_batched.sweep``) counts on its own
  kernel's children but not again in the totals.
* **Host stages**: ``with stage(key):`` times work that runs on the
  host by ``time.perf_counter()`` (the scheduler's worker loop:
  ``serving.wait``, ``serving.dispatch``, ``serving.result``). A stage
  records ``calls`` and ``exec_s`` under its key in ``kernel_stats()``
  and nothing else: no metric family, no span, nothing in ``stats()``
  (so ``ProfileWindow`` and the scheduler's ``device_cost`` stay device
  time). A device seam inside a stage counts as top-level, exactly as
  if the stage were absent, and a build during a stage is attributed
  to the seam in flight or to the library, as elsewhere.
* **Build accounting**: every nvcc (or g++) compile that
  ``titan_tpu_torch/build.py`` runs counts on ``device.compile.count`` /
  ``device.compile.ms``, under the seam in flight on the thread when
  there is one (that call is then not a cache hit), else under the
  library's name. A library already built counts nothing.
* **Transfer accounting**: the upload and readback seams
  (``bfs_hybrid.build_chunked_csr``, ``engine.device_graph``, result
  readbacks) call :func:`count_h2d` / :func:`count_d2h` with their byte
  counts, at the JAX package's site names.

Export: ``device.compile.*`` / ``device.exec.*`` / ``device.xfer.*``
families through ``utils/metrics`` (children keyed by ``{kernel}`` /
``{site}``). ``device.exec.calls`` and the warm calls'
``device.compile.cache_hits`` count at the call; ``device.exec.ms``
when the call's events are resolved.

Profilers install process-wide; more than one may be installed, and a
call is measured once and fanned out. With none installed each seam and
stage is one module-global load and a truth test (``seam`` and
``stage`` then return one shared no-op context): no clock read, no CUDA
event, no allocation. While a ``torch.profiler`` session is recording
(any thread's), every measured seam and stage also opens a
``torch.profiler.record_function(key)`` range, so it lies in the Kineto
trace on the device events' own clock; a session records another
thread's ranges only when it profiles all threads
(``_ExperimentalConfig(profile_all_threads=True)``). With no session
recording no range object is made. The profiler never touches the
computation, so results are bit-equal with profiling on or off.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _torch_profiler

from titan_tpu_torch import build
from titan_tpu_torch.utils.metrics import MetricManager

#: installed profilers, in install order (process-wide)
_PROFILERS: list = []
_INSTALL_LOCK = threading.Lock()
_TLS = threading.local()
#: CUDA calls whose event pair is not resolved yet:
#: (key, start, end, top_level, profilers)
_PENDING: list = []
_PENDING_LOCK = threading.Lock()
_RESOLVE_LOCK = threading.Lock()
#: past this many pending pairs a new call resolves the finished ones
MAX_PENDING = 4096


def _on_build(name: str, seconds: float) -> None:
    """``build.ON_BUILD`` listener: a compile that ran, attributed to the
    seam in flight on this thread, else to the library's name."""
    if not _PROFILERS:
        return
    ctx = getattr(_TLS, "ctx", None)
    if ctx is not None:
        ctx["compiled"] = True
    key = ctx["key"] if ctx is not None else name
    for prof in list(_PROFILERS):
        prof.on_build(key, seconds)


def _device_of(args) -> Optional[torch.device]:
    """The device of the first tensor among ``args``, looking one level
    into dicts, tuples and lists (a state dict, a device graph)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        items = a.values() if isinstance(a, dict) else \
            a if isinstance(a, (tuple, list)) else ()
        for x in items:
            if isinstance(x, torch.Tensor):
                return x.device
    return None


class _Off:
    """The context every seam and stage returns while no profiler is
    installed: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _range(key: str):
    """A ``record_function`` range named ``key``, entered, while a
    ``torch.profiler`` session is recording; None otherwise."""
    if not _torch_profiler._is_profiler_enabled:
        return None
    rf = _torch_profiler.record_function(key)
    rf.__enter__()
    return rf


class _Seam:
    """One measured run of a device seam, fanned out to the profilers
    installed when it started (see the module doc)."""

    __slots__ = ("key", "device", "profs", "prev", "ctx", "rf", "stream",
                 "start", "t0")

    def __init__(self, key: str, device: Optional[torch.device]):
        self.key = key
        self.device = device

    def __enter__(self) -> "_Seam":
        self.profs = list(_PROFILERS)
        self.prev = getattr(_TLS, "ctx", None)
        self.ctx = _TLS.ctx = {"key": self.key, "compiled": False}
        self.rf = _range(self.key)
        self.stream = None
        dev = self.device
        if dev is not None and dev.type == "cuda":
            self.stream = torch.cuda.current_stream(dev)
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        _TLS.ctx = self.prev
        wall = time.perf_counter() - self.t0
        key, profs, top = self.key, self.profs, self.prev is None
        for prof in profs:
            prof.on_call(key, self.ctx["compiled"])
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            with _PENDING_LOCK:
                _PENDING.append((key, self.start, end, top, profs))
                crowded = len(_PENDING) > MAX_PENDING
            if crowded:
                _resolve(block=False)
        else:
            for prof in profs:
                prof.on_exec(key, wall, top)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


class _Stage:
    """One timed run of a host stage (see the module doc)."""

    __slots__ = ("key", "profs", "rf", "t0")

    def __init__(self, key: str):
        self.key = key

    def __enter__(self) -> "_Stage":
        self.profs = list(_PROFILERS)
        self.rf = _range(self.key)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        secs = time.perf_counter() - self.t0
        for prof in self.profs:
            prof.on_stage(self.key, secs)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def _resolve(block: bool = True) -> None:
    """Turn pending event pairs into exec times: all of them (waiting
    for each end event), or with ``block=False`` the finished prefix,
    and then only when no other thread is resolving."""
    if not _RESOLVE_LOCK.acquire(blocking=block):
        return
    try:
        with _PENDING_LOCK:
            todo = list(_PENDING)
        done = 0
        for key, start, end, top, profs in todo:
            if not block and not end.query():
                break
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
            for prof in profs:
                prof.on_exec(key, secs, top)
            done += 1
        with _PENDING_LOCK:
            del _PENDING[:done]
    finally:
        _RESOLVE_LOCK.release()


def profiled(key: str, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the installed profilers (see the
    module doc), on the device of its first tensor argument; with none
    installed, just run it."""
    if not _PROFILERS:
        return fn(*args, **kwargs)
    with _Seam(key, _device_of(args)):
        return fn(*args, **kwargs)


def seam(key: str, device: Optional[torch.device]):
    """``with seam(key, device):`` measures the block as ``profiled``
    measures a call: CUDA events on ``device``'s current stream on a
    card, the host wall elsewhere (``device`` None or not CUDA). With no
    profiler installed, the shared no-op context."""
    if not _PROFILERS:
        return _OFF
    return _Seam(key, device)


def stage(key: str):
    """``with stage(key):`` times a block of host work by the host's
    clock, into ``kernel_stats()`` only (see the module doc). With no
    profiler installed, the shared no-op context."""
    if not _PROFILERS:
        return _OFF
    return _Stage(key)


def count_h2d(site: str, nbytes: int) -> None:
    """Attribute ``nbytes`` of host→device transfer to ``site``."""
    if _PROFILERS and nbytes:
        for prof in list(_PROFILERS):
            prof.on_xfer("h2d", site, int(nbytes))


def count_d2h(site: str, nbytes: int) -> None:
    """Attribute ``nbytes`` of device→host readback to ``site``."""
    if _PROFILERS and nbytes:
        for prof in list(_PROFILERS):
            prof.on_xfer("d2h", site, int(nbytes))


def current() -> Optional["DeviceCostProfiler"]:
    """The most recently installed profiler, or None."""
    return _PROFILERS[-1] if _PROFILERS else None


class DeviceCostProfiler:
    """Process-wide device-cost accounting into a metrics registry.

    Per profiled call: ``device.exec.calls`` / ``device.exec.ms``
    (labeled ``{kernel}``), ``device.compile.cache_hits`` when no build
    ran inside it. Per build: ``device.compile.count`` +
    ``device.compile.ms``. Transfer seams land on
    ``device.xfer.h2d_bytes`` / ``device.xfer.d2h_bytes`` (labeled
    ``{site}``). A bounded ``compile_log`` keeps the recent builds for
    postmortem bundles, and ``window()`` captures totals deltas for
    per-batch attribution.

    ``recorder`` (obs/flightrec.FlightRecorder) receives a compact
    device event per resolved call when attached.
    """

    def __init__(self, metrics: Optional[MetricManager] = None,
                 recorder=None, max_compile_log: int = 256):
        self.metrics = metrics or MetricManager.instance()
        self.recorder = recorder
        self.max_compile_log = int(max_compile_log)
        self._lock = threading.Lock()
        self._kernels: dict[str, dict] = {}
        self._compile_log: list[dict] = []
        self._totals = {"calls": 0, "compiles": 0, "cache_hits": 0,
                        "compile_s": 0.0, "exec_s": 0.0,
                        "h2d_bytes": 0, "d2h_bytes": 0}

    # -- lifecycle -----------------------------------------------------------

    def install(self) -> "DeviceCostProfiler":
        with _INSTALL_LOCK:
            if self not in _PROFILERS:
                _PROFILERS.append(self)
            if _on_build not in build.ON_BUILD:
                build.ON_BUILD.append(_on_build)
        return self

    def uninstall(self) -> None:
        # pending calls keep this profiler in their fan-out: resolve
        # them first, so its totals are complete once it is out
        _resolve()
        with _INSTALL_LOCK:
            if self in _PROFILERS:
                _PROFILERS.remove(self)

    def __enter__(self) -> "DeviceCostProfiler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    @property
    def installed(self) -> bool:
        return self in _PROFILERS

    # -- record side ---------------------------------------------------------

    def _kernel(self, key: str) -> dict:
        return self._kernels.setdefault(
            key, {"calls": 0, "compiles": 0, "cache_hits": 0,
                  "compile_s": 0.0, "exec_s": 0.0})

    def on_call(self, key: str, compiled: bool) -> None:
        m = self.metrics
        m.counter("device.exec.calls", labels={"kernel": key}).inc()
        if not compiled:
            m.counter("device.compile.cache_hits",
                      labels={"kernel": key}).inc()
        with self._lock:
            k = self._kernel(key)
            k["calls"] += 1
            self._totals["calls"] += 1
            if not compiled:
                k["cache_hits"] += 1
                self._totals["cache_hits"] += 1

    def on_exec(self, key: str, seconds: float, top_level: bool) -> None:
        self.metrics.histogram("device.exec.ms",
                               labels={"kernel": key}).update(seconds * 1e3)
        with self._lock:
            self._kernel(key)["exec_s"] += seconds
            if top_level:
                self._totals["exec_s"] += seconds
        rec = self.recorder
        if rec is not None:
            rec.record("device", kernel=key, ms=round(seconds * 1e3, 3))

    def on_stage(self, key: str, seconds: float) -> None:
        """A host stage's run: its key's calls and seconds, nothing
        more (module doc)."""
        with self._lock:
            k = self._kernel(key)
            k["calls"] += 1
            k["exec_s"] += seconds

    def on_build(self, key: str, seconds: float) -> None:
        m = self.metrics
        m.counter("device.compile.count", labels={"kernel": key}).inc()
        m.histogram("device.compile.ms",
                    labels={"kernel": key}).update(seconds * 1e3)
        with self._lock:
            k = self._kernel(key)
            k["compiles"] += 1
            k["compile_s"] += seconds
            self._totals["compiles"] += 1
            self._totals["compile_s"] += seconds
            self._compile_log.append(
                {"t": time.time(), "kernel": key,
                 "compile_ms": round(seconds * 1e3, 3)})
            if len(self._compile_log) > self.max_compile_log:
                del self._compile_log[0]
        rec = self.recorder
        if rec is not None:
            rec.record("device", kernel=key, compiled=True,
                       compile_ms=round(seconds * 1e3, 3))

    def on_xfer(self, direction: str, site: str, nbytes: int) -> None:
        name = "device.xfer.h2d_bytes" if direction == "h2d" \
            else "device.xfer.d2h_bytes"
        self.metrics.counter(name, labels={"site": site}).inc(nbytes)
        with self._lock:
            self._totals[f"{direction}_bytes"] += nbytes
        rec = self.recorder
        if rec is not None:
            rec.record("xfer", dir=direction, site=site, bytes=nbytes)

    # -- read side (each read resolves the pending CUDA events) --------------

    def kernel_stats(self) -> dict:
        """Per-kernel accumulated stats (calls / compiles / cache hits /
        compile + exec seconds), keyed by seam key; a host stage's key
        counts only its calls and seconds."""
        _resolve()
        with self._lock:
            return {k: dict(v) for k, v in sorted(self._kernels.items())}

    def compiles(self, key: Optional[str] = None) -> int:
        """Builds so far, under ``key`` or in total."""
        with self._lock:
            if key is not None:
                k = self._kernels.get(key)
                return k["compiles"] if k is not None else 0
            return self._totals["compiles"]

    def compile_log(self) -> list:
        """The last ``max_compile_log`` builds (newest last)."""
        with self._lock:
            return [dict(e) for e in self._compile_log]

    def stats(self) -> dict:
        """Process totals: calls / compiles / cache hits, compile and
        top-level exec seconds, H2D/D2H bytes."""
        _resolve()
        with self._lock:
            out = dict(self._totals)
        out["compile_s"] = round(out["compile_s"], 6)
        out["exec_s"] = round(out["exec_s"], 6)
        return out

    def window(self) -> "ProfileWindow":
        """Open a totals-delta window (per-batch attribution). Activity
        from other threads lands in every open window — windows measure
        the process, not a thread."""
        return ProfileWindow(self)


class ProfileWindow:
    """Totals snapshot at open; ``close()`` returns the delta."""

    __slots__ = ("_prof", "_t0", "_base")

    def __init__(self, prof: DeviceCostProfiler):
        self._prof = prof
        self._t0 = time.time()
        self._base = prof.stats()

    def close(self) -> dict:
        now = self._prof.stats()
        out = {k: now[k] - self._base[k] for k in now}
        out["compile_s"] = round(out["compile_s"], 6)
        out["exec_s"] = round(out["exec_s"], 6)
        out["wall_s"] = round(time.time() - self._t0, 6)
        return out
