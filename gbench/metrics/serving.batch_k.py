"""Jobs a batch: the mean fused K of the BFS jobs that finished inside
the window, as the scheduler recorded it on each job."""

from gbench.metrics import _window as W


def read(run):
    ks = [j["batch_k"] for j in W.finished_in_window(run, "bfs")]
    return sum(ks) / len(ks) if ks else None
