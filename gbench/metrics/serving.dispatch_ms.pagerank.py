"""The scheduler's own work around a ``dense`` PageRank job's model call
(host clock): the ``serving.dispatch`` stage's milliseconds a job over
the window."""

from gbench.metrics import _stages as S


def read(run):
    return S.ms_per(run, "serving.dispatch", "engine.prepare", "dense")
