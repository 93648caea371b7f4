"""The batcher's result assembly of a ``dense`` PageRank job (host
clock): the ``serving.result`` stage's milliseconds (the outputs as
arrays and the completion, inside the job's run span) a job over the
window."""

from gbench.metrics import _stages as S


def read(run):
    return S.ms_per(run, "serving.result", "engine.prepare", "dense")
