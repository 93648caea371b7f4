"""The batcher's result assembly of a BFS batch (host clock): the K rows'
result dicts and completions after the run spans close, the
``serving.result`` stage's milliseconds a batch over the window."""

from gbench.metrics import _stages as S


def read(run):
    return S.ms_per(run, "serving.result", "serving.result", "bfs")
