"""The scheduler's and batcher's own work around a BFS batch's model call
(host clock): the ``serving.dispatch`` stage's milliseconds a batch
over the window (the tick and pop, the lease and ledger, the batcher's
source resolution and fuse records, and after the call the
attribution, the profile window's close and each job's terminal
metrics)."""

from gbench.metrics import _stages as S


def read(run):
    return S.ms_per(run, "serving.dispatch", "serving.result", "bfs")
