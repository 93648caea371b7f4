"""R-MAT / Graph500-style Kronecker edge-list generator (the port's copy
of titan_tpu/olap/tpu/rmat.py).

(BASELINE configs #3-#5 use LiveJournal/Twitter/Graph500 graphs; with zero
egress we generate Graph500's synthetic R-MAT (A,B,C,D)=(.57,.19,.19,.05)
power-law graphs of the same scale instead. Vectorized numpy, chunked so
scale-26 generation stays in bounded memory.)
"""

from __future__ import annotations

import numpy as np


def rmat_edges(scale: int, edge_factor: int = 16, seed: int = 1,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               chunk: int = 1 << 24) -> tuple[np.ndarray, np.ndarray]:
    """Returns (src, dst) int32/int64 arrays of 2^scale-vertex R-MAT edges."""
    n_edges = (1 << scale) * edge_factor
    rng = np.random.default_rng(seed)
    dtype = np.int32 if scale < 31 else np.int64
    src = np.empty(n_edges, dtype=dtype)
    dst = np.empty(n_edges, dtype=dtype)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    for start in range(0, n_edges, chunk):
        m = min(chunk, n_edges - start)
        s = np.zeros(m, dtype=dtype)
        t = np.zeros(m, dtype=dtype)
        for bit in range(scale):
            # two float32 draws per bit: one for the row half, one shared
            # for the column (its threshold is selected by `down`, and
            # conditioned on `down` the uniform is independent — same
            # distribution as three draws at ~1/3 the rng cost)
            down = rng.random(m, dtype=np.float32) > ab
            u = rng.random(m, dtype=np.float32)
            right = np.where(down, u > c_norm, u > a_norm)
            s |= (down.astype(dtype) << bit)
            t |= (right.astype(dtype) << bit)
        # scramble to break locality (Graph500 permutes vertex ids)
        src[start:start + m] = s
        dst[start:start + m] = t
    perm = _scramble(1 << scale, seed, dtype)
    return perm[src], perm[dst]


def _scramble(n: int, seed: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(seed + 0xC0FFEE)
    perm = np.arange(n, dtype=dtype)
    rng.shuffle(perm)
    return perm
