"""LDBC Graphalytics' EVPS over the window: |V| + |E| of the dataset for
each PageRank job that finished inside the window, over the window's
seconds."""

from gbench.metrics import _window as W


def read(run):
    jobs = W.finished_in_window(run, "dense")
    if not any(j["kind"] == "dense" for j in run["jobs"]):
        return None
    return sum(j["work"]["ev"] for j in jobs) / run["window_s"]
