"""The share of the window that the batcher's ``run`` spans of ``dense``
(PageRank) jobs cover; one minus it is the serving layer's own time."""

from gbench.metrics import _window as W


def read(run):
    spans = W.run_spans(run, "dense")
    if not spans:
        return None
    t0, t1 = run["window"]
    return W.union_seconds(spans, t0, t1) / (t1 - t0)
