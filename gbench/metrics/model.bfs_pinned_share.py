"""The share of the batched BFS's ``[K, n]`` readbacks that landed in a
page-locked buffer of the port's pool: the window's calls of the host
stage ``bfs_batched.readback.pinned`` over those of the device seam
``bfs_batched.readback``, in a run that served BFS. None where the
program has no such stage, or no readback ran in the window."""

from gbench.metrics import _stages as S


def read(run):
    prof = run.get("devprof") or {}
    pinned, every = prof.get("bfs_batched.readback.pinned"), \
        prof.get("bfs_batched.readback")
    if pinned is None or every is None or every["calls"] <= 0 \
            or not S.serves(run, "bfs"):
        return None
    return pinned["calls"] / every["calls"]
