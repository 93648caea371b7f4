"""The mean ``run`` span of a BFS batch that started inside the window
(host clock): the batched BFS's device run and its ``[K, n]`` readback
and the rows' host work."""

from gbench.metrics import _window as W


def read(run):
    t0, t1 = run["window"]
    spans = [(a, b) for a, b in W.run_spans(run, "bfs") if t0 <= a < t1]
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) * 1e3
