"""Timestamp providers.

Counterpart of the reference's TimestampProvider family (reference:
titan-core diskstorage/util/time/TimestampProviders.java): monotonic-ish
wall-clock sources at NANO/MICRO/MILLI resolution, plus ``sleep_past`` used
by the locking and id-authority claim protocols to wait until the clock has
certainly advanced past a given instant.
"""

from __future__ import annotations

import threading
import time


class TimestampProvider:
    """Base: times are integer units-since-epoch at the provider's resolution."""

    unit_per_second: int = 1_000_000

    def time(self) -> int:
        return int(time.time() * self.unit_per_second)

    def seconds(self, t: int) -> float:
        return t / self.unit_per_second

    def from_seconds(self, s: float) -> int:
        return int(s * self.unit_per_second)

    def sleep_past(self, instant: int) -> int:
        """Block until ``time() > instant``; returns the new time."""
        while True:
            now = self.time()
            if now > instant:
                return now
            time.sleep(max((instant - now + 1) / self.unit_per_second, 1e-6))


class NanoProvider(TimestampProvider):
    unit_per_second = 1_000_000_000

    def time(self) -> int:
        return time.time_ns()


class MicroProvider(TimestampProvider):
    unit_per_second = 1_000_000

    def time(self) -> int:
        return time.time_ns() // 1_000


class MilliProvider(TimestampProvider):
    unit_per_second = 1_000

    def time(self) -> int:
        return time.time_ns() // 1_000_000


_PROVIDERS = {"nano": NanoProvider(), "micro": MicroProvider(),
              "milli": MilliProvider()}


def provider(name: str) -> TimestampProvider:
    return _PROVIDERS[name]


class SequenceClock(TimestampProvider):
    """Deterministic test clock: strictly increasing counter."""

    def __init__(self, start: int = 0):
        self._t = start
        self._lock = threading.Lock()

    def time(self) -> int:
        with self._lock:
            self._t += 1
            return self._t

    def sleep_past(self, instant: int) -> int:
        with self._lock:
            self._t = max(self._t, instant) + 1
            return self._t
