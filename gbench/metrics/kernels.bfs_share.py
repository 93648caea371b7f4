"""The BFS kernels' share of the BFS batches' runs: the device-cost
profiler's ``frontier_round`` and ``batched_exhaust`` seconds over the
window, over the seconds of the BFS ``run`` spans in it."""

from gbench.metrics import _window as W


def read(run):
    if not run.get("on_card"):
        return None
    prof = run.get("devprof")
    spans = W.run_spans(run, "bfs")
    if not prof or not spans:
        return None
    t0, t1 = run["window"]
    ran = W.union_seconds(spans, t0, t1)
    kern = sum(prof.get(k, {}).get("exec_s", 0.0)
               for k in ("frontier_round", "batched_exhaust"))
    if ran <= 0 or kern <= 0:
        return None
    return kern / ran
