"""Plain BFS over the benchmark's own edge list: the reference the served
BFS rows are held to, and the count of Graph500's TEPS numerator.

Level-synchronous and top-down over every edge tuple each level, in
plain PyTorch: a tuple ``(u, w)`` whose end is in the frontier reaches
its other end (the graph is undirected). Self-loops and duplicates reach
nothing new, so the tuple list needs no dedup. ``directed=True`` follows
``u -> w`` only: the control, which breaks the configuration's
"undirected".

It imports nothing of the system under test.
"""

from __future__ import annotations

import torch

#: edge tuples a step (bounds the temporaries at SCALE 26)
CHUNK = 1 << 27
#: the marker of a vertex no level reaches
UNREACHED = -1


def bfs(u: torch.Tensor, w: torch.Tensor, n: int, source: int,
        directed: bool = False) -> tuple:
    """``(dist, levels)``: dist int32 [n] (``UNREACHED`` off the source's
    component), levels = the deepest level + 1."""
    dev = u.device
    dist = torch.full((n,), UNREACHED, dtype=torch.int32, device=dev)
    dist[source] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[source] = True
    level = 0
    while True:
        found = torch.zeros(n, dtype=torch.bool, device=dev)
        for start in range(0, u.shape[0], CHUNK):
            uu = u[start:start + CHUNK]
            ww = w[start:start + CHUNK]
            found[ww[frontier.index_select(0, uu)].long()] = True
            if not directed:
                found[uu[frontier.index_select(0, ww)].long()] = True
        found &= dist == UNREACHED
        if not bool(found.any()):
            return dist, level + 1
        level += 1
        dist[found] = level
        frontier = found


def component_tuples(u: torch.Tensor, w: torch.Tensor,
                     reached: torch.Tensor) -> int:
    """Graph500's TEPS numerator for one search: the input tuples,
    duplicates and self-loops included, whose ends lie in the traversed
    component (``reached``, bool [n]; an undirected edge has both ends in
    one component, so its first end decides)."""
    total = 0
    for start in range(0, u.shape[0], CHUNK):
        total += int(reached.index_select(0, u[start:start + CHUNK]).sum())
    return total
