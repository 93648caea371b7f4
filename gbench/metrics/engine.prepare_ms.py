"""The engine's work before a job's first superstep on the card: the
device-cost profiler's ``engine.prepare`` milliseconds (the state's
init, the device graph, the parameters' upload) a job over the window."""

from gbench.metrics import _stages as S


def read(run):
    return S.ms_per(run, "engine.prepare", "engine.prepare", "dense",
                    device=True)
