"""Shared arithmetic of the stage readers: the seconds of the system
under test's ``obs/devprof`` seams over the window (a traced run's
``run["devprof"]`` deltas), a batch or a job at a time, or as a share of
the window. A batch is a ``serving.result`` call (the batcher assembles
each batch's results once), a superstep an ``engine.superstep`` call and
a job an ``engine.prepare`` call. Host stages (``serving.*``) are the
host's clock and read anywhere; the device seams are CUDA-event time and
read on the card only."""

from __future__ import annotations


def _seam(run: dict, key: str):
    """The window's ``{"calls", "exec_s"}`` of ``key``, or None where the
    program has no such seam."""
    return (run.get("devprof") or {}).get(key)


def serves(run: dict, kind: str) -> bool:
    """Whether the run served jobs of ``kind``."""
    return any(j["kind"] == kind for j in run.get("jobs", ()))


def ms_per(run: dict, key: str, per: str, kind: str,
           device: bool = False):
    """``key``'s milliseconds over the window per call of ``per``, in a
    run that served ``kind``; None where either seam is absent or
    ``per`` was not called, and off the card for a device seam."""
    if device and not run.get("on_card"):
        return None
    k, p = _seam(run, key), _seam(run, per)
    if k is None or p is None or p["calls"] <= 0 or not serves(run, kind):
        return None
    return k["exec_s"] / p["calls"] * 1e3


def share(run: dict, key: str, kind: str):
    """``key``'s seconds over the window's, in a run that served
    ``kind``; None where the seam is absent."""
    k = _seam(run, key)
    if k is None or not serves(run, kind):
        return None
    t0, t1 = run["window"]
    return k["exec_s"] / (t1 - t0)
