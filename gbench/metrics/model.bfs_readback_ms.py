"""The batched BFS's final ``[K, n]`` copy to the host on the card: the
device-cost profiler's ``bfs_batched.readback`` milliseconds a batch
over the window."""

from gbench.metrics import _stages as S


def read(run):
    return S.ms_per(run, "bfs_batched.readback", "serving.result", "bfs",
                    device=True)
