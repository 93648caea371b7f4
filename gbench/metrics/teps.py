"""Graph500 TEPS over the window: the input tuples in each finished
search's component, summed over the BFS jobs that finished inside the
window, over the window's seconds."""

from gbench.metrics import _window as W


def read(run):
    jobs = W.finished_in_window(run, "bfs")
    if not any(j["kind"] == "bfs" for j in run["jobs"]):
        return None
    return sum(j["work"]["edges"] for j in jobs) / run["window_s"]
