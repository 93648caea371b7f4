"""The engine's per-destination combine on the card (``seg_scan`` inside):
the device-cost profiler's ``engine.combine`` milliseconds a superstep
over the window."""

from gbench.metrics import _stages as S


def read(run):
    return S.ms_per(run, "engine.combine", "engine.superstep", "dense",
                    device=True)
