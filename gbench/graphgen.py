"""The benchmark's own Graph500 Kronecker generator, in PyTorch on the
device, from the run's seed.

Graph500 v3's kernel-1 input: ``edgefactor * 2^scale`` edge tuples over
``2^scale`` vertices. Each tuple takes one quadrant of the 2 x 2 initiator
``[[A, B], [C, D]]`` per bit of the vertex ids (one uniform draw a bit),
then every vertex id goes through one random permutation (the spec's
vertex scramble). Duplicates and self-loops are kept: Graph500 counts
them in TEPS, and the system under test drops them when it builds its
graph. The seed-to-graph mapping (Philox draws of one
``torch.Generator`` on the card, in fixed-size chunks) is the
benchmark's own, so one seed gives one edge list on any card of one
PyTorch build.

Nothing here imports the system under test.
"""

from __future__ import annotations

import torch

#: edge tuples generated a chunk (a chunk's draws are one call per bit)
CHUNK = 1 << 26


def kronecker_edges(scale: int, edgefactor: int, seed: int, a: float,
                    b: float, c: float, device) -> tuple:
    """``(u, v)``: int32 tensors of ``edgefactor << scale`` edge tuples
    on ``device``."""
    n = 1 << scale
    m = edgefactor << scale
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.empty(m, dtype=torch.int32, device=device)
    v = torch.empty(m, dtype=torch.int32, device=device)
    ab, abc = a + b, a + b + c
    for start in range(0, m, CHUNK):
        k = min(CHUNK, m - start)
        s = torch.zeros(k, dtype=torch.int32, device=device)
        t = torch.zeros(k, dtype=torch.int32, device=device)
        for bit in range(scale):
            r = torch.rand(k, generator=gen, device=device)
            # quadrant A: (0, 0), B: (0, 1), C: (1, 0), D: (1, 1)
            row = r >= ab
            col = ((r >= a) & ~row) | (r >= abc)
            s |= row.to(torch.int32) << bit
            t |= col.to(torch.int32) << bit
        u[start:start + k] = s
        v[start:start + k] = t
        del s, t, r, row, col
    perm = torch.randperm(n, generator=gen, device=device,
                          dtype=torch.int32)
    for start in range(0, m, CHUNK):
        sl = slice(start, min(start + CHUNK, m))
        u[sl] = perm.index_select(0, u[sl])
        v[sl] = perm.index_select(0, v[sl])
    return u, v


def degrees(u: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """Each vertex's count of incident tuples that are not self-loops
    (int64 [n]): a search key needs one."""
    deg = torch.zeros(n, dtype=torch.int64, device=u.device)
    for start in range(0, u.shape[0], CHUNK):
        uu = u[start:start + CHUNK]
        vv = v[start:start + CHUNK]
        keep = uu != vv
        ones = keep.to(torch.int64)
        deg.index_add_(0, uu, ones)
        deg.index_add_(0, vv, ones)
    return deg


def search_keys(deg: torch.Tensor, count: int, seed: int) -> list:
    """``count`` distinct vertices of degree > 0, drawn from the seed
    (Graph500's search keys), in the order drawn."""
    nz = torch.nonzero(deg > 0).flatten()
    gen = torch.Generator(device=deg.device)
    gen.manual_seed(int(seed) ^ 0x5EA4C4)
    pick = torch.randperm(nz.shape[0], generator=gen,
                          device=deg.device)[:count]
    return [int(x) for x in nz[pick].tolist()]
