"""The share of the window the scheduler's worker spent blocked on an
empty queue in a BFS cell (host clock): the ``serving.wait`` stage's
seconds over the window's."""

from gbench.metrics import _stages as S


def read(run):
    return S.share(run, "serving.wait", "bfs")
