"""The card's idle share in the profiled slice of a BFS cell's window:
one minus the union of its kernels, copies and memsets over the slice."""

from gbench.metrics import _window as W


def read(run):
    sl = run.get("slice")
    if sl is None or sl.window_s <= 0 or not W.run_spans(run, "bfs"):
        return None
    return 1.0 - sl.busy_s / sl.window_s
