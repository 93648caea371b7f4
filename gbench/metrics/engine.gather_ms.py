"""The engine's gather of the state at the edges' sources on the card:
the device-cost profiler's ``engine.gather`` milliseconds a superstep
over the window."""

from gbench.metrics import _stages as S


def read(run):
    return S.ms_per(run, "engine.gather", "engine.superstep", "dense",
                    device=True)
