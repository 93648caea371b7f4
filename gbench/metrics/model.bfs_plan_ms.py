"""The batched BFS's plans on the card: the device-cost profiler's
``bfs_batched.plan`` milliseconds (each level's plan, re-plans
included, with its stats readback) a batch over the window."""

from gbench.metrics import _stages as S


def read(run):
    return S.ms_per(run, "bfs_batched.plan", "serving.result", "bfs",
                    device=True)
