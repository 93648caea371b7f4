"""Deadline-driven micro-batcher: pack point queries into fused runs (the
port's copy of ``titan_tpu/olap/serving/interactive/collector.py``; pure
host code).

The low-latency queue of the interactive lane. Concurrent ``POST
/traverse`` requests land here; requests whose plans share a
``fuse_key()`` (same snapshot selection + workload family —
``interactive/compile.py``) collect into ONE pending group. A group
flushes to the lane's worker when EITHER

* it fills to ``max_fuse`` members (flushed immediately — a full
  ``[K, n]`` batch gains nothing by waiting), or
* its fuse window (``window_s``, a few ms) expires — the deadline that
  bounds the latency a lone query pays for fusion.

This is deliberately NOT the heavy OLAP heap (olap/serving/scheduler):
no priorities, no deadlines-before-start, no retry plane — a point
query that fails answers its caller with the error and is gone. The
caller's thread BLOCKS on its request event (the endpoint is
synchronous; sub-ms device time + a few-ms window), so the queue depth
is bounded by the HTTP server's handler pool.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

#: default fuse window — long enough to catch a concurrent burst from
#: many users, short enough to stay invisible next to interpreter-era
#: latencies
DEFAULT_WINDOW_S = 0.002
DEFAULT_MAX_FUSE = 16


class InteractiveRequest:
    """One caller's blocking request: plan + identity + rendezvous."""

    __slots__ = ("plan", "tenant", "submitted_at", "result", "error",
                 "wait_ms", "_done")

    def __init__(self, plan, tenant: str):
        self.plan = plan
        self.tenant = tenant
        self.submitted_at = time.time()
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self.wait_ms: float = 0.0
        self._done = threading.Event()

    def finish(self, result: Optional[dict] = None,
               error: Optional[BaseException] = None) -> None:
        self.result = result
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float]) -> bool:
        return self._done.wait(timeout)


class _Group:
    __slots__ = ("key", "members", "due_at")

    def __init__(self, key, due_at: float):
        self.key = key
        self.members: list = []
        self.due_at = due_at


class Collector:
    """See module doc. Thread-safe; ``pop_due`` is the single worker's
    blocking drain."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 max_fuse: int = DEFAULT_MAX_FUSE):
        self.window_s = float(window_s)
        self.max_fuse = int(max_fuse)
        self._cv = threading.Condition()
        self._pending: dict = {}        # fuse_key -> _Group
        self._ready: deque = deque()    # full groups, FIFO
        self._closed = False

    def submit(self, req: InteractiveRequest) -> None:
        key = req.plan.fuse_key()
        with self._cv:
            if self._closed:
                raise RuntimeError("interactive lane is closed")
            grp = self._pending.get(key)
            if grp is None:
                grp = _Group(key, time.time() + self.window_s)
                self._pending[key] = grp
            grp.members.append(req)
            if len(grp.members) >= self.max_fuse:
                # full: flush now, don't wait out the window
                del self._pending[key]
                self._ready.append(grp)
            self._cv.notify()

    def pop_due(self) -> Optional[_Group]:
        """Block until a group is due (full, or window expired); None
        once closed AND drained — close() lets queued callers get
        answers instead of hanging."""
        with self._cv:
            while True:
                if self._ready:
                    return self._ready.popleft()
                if self._closed:
                    if self._pending:
                        _k, grp = self._pending.popitem()
                        return grp
                    return None
                now = time.time()
                due_key, earliest = None, None
                for key, grp in self._pending.items():
                    if now >= grp.due_at:
                        due_key = key
                        break
                    if earliest is None or grp.due_at < earliest:
                        earliest = grp.due_at
                if due_key is not None:
                    return self._pending.pop(due_key)
                self._cv.wait(None if earliest is None
                              else max(earliest - now, 1e-4))

    def depth(self) -> int:
        with self._cv:
            return sum(len(g.members) for g in self._pending.values()) \
                + sum(len(g.members) for g in self._ready)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
