"""The share of the window that the batcher's ``run`` spans of BFS
batches cover; one minus it is the serving layer's own time around the
model runs."""

from gbench.metrics import _window as W


def read(run):
    spans = W.run_spans(run, "bfs")
    if not spans:
        return None
    t0, t1 = run["window"]
    return W.union_seconds(spans, t0, t1) / (t1 - t0)
