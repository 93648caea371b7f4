"""The batched BFS's sweeps on the card: the device-cost profiler's
``bfs_batched.sweep`` milliseconds (each level from the frontier words'
share through the chunk rounds, the progress readback and the
stragglers' sweep, the two BFS kernels inside) a batch over the window."""

from gbench.metrics import _stages as S


def read(run):
    return S.ms_per(run, "bfs_batched.sweep", "serving.result", "bfs",
                    device=True)
