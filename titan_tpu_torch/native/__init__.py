"""The port's native Graph500 host pipeline (``src/graph500.cpp``),
built with ``g++`` at first use into ``native/_build/`` and bound with
ctypes.

A failed build raises: the native and numpy generators give different
edge sets for the same seed, so switching quietly to numpy would change
the benchmark graph. Callers that want numpy ask for it
(``olap.graph500.load_or_build(..., generator="numpy")``).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from titan_tpu_torch.build import build_shared

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "src", "graph500.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")


@functools.cache
def library() -> ctypes.CDLL:
    cxx = os.environ.get("CXX", "g++")
    path = build_shared(SRC, [cxx, "-O3", "-std=c++17", "-fPIC", "-Wall",
                              "-Wextra", "-shared", "-pthread"],
                        BUILD_DIR, "graph500")
    lib = ctypes.CDLL(path)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.tt_rmat_gen.restype = None
    lib.tt_rmat_gen.argtypes = [i64, ctypes.c_int, ctypes.c_uint64,
                                ctypes.c_double, ctypes.c_double,
                                ctypes.c_double, i32p, i32p]
    lib.tt_sym_chunked_csr.restype = i64
    lib.tt_sym_chunked_csr.argtypes = [
        i32p, i32p, i64, i64, i32p, i32p, i64p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))]
    lib.tt_free.restype = None
    lib.tt_free.argtypes = [ctypes.c_void_p]
    return lib


def rmat_gen(m: int, scale: int, seed: int = 1, a: float = 0.57,
             b: float = 0.19, c: float = 0.19
             ) -> tuple[np.ndarray, np.ndarray]:
    """Graph500-style R-MAT edges: (src, dst) int32[m] over 2^scale
    vertices, with a bijective avalanche scramble of vertex ids."""
    src = np.empty(m, dtype=np.int32)
    dst = np.empty(m, dtype=np.int32)
    library().tt_rmat_gen(m, scale, seed & 0xFFFFFFFFFFFFFFFF, a, b, c,
                          src, dst)
    return src, dst


def sym_chunked_csr(src: np.ndarray, dst: np.ndarray, n: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """Symmetrized + deduped + 8-aligned chunked CSR.

    Returns (dstT int32[8, q_total] with pad n+1, colstart int64[n+1],
    deg int32[n] post-dedup, deg_orig int32[n] pre-dedup symmetrized
    degrees for Graph500 TEPS accounting)."""
    lib = library()
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if src.shape != dst.shape:
        raise ValueError("src and dst differ in length")
    if len(src) and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= n):
        raise ValueError("edge endpoint outside [0, n)")
    deg_orig = np.zeros(n, dtype=np.int32)
    deg = np.zeros(n, dtype=np.int32)
    colstart = np.zeros(n + 1, dtype=np.int64)
    ptr = ctypes.POINTER(ctypes.c_int32)()
    q_total = lib.tt_sym_chunked_csr(src, dst, len(src), n, deg_orig, deg,
                                     colstart, ctypes.byref(ptr))
    if q_total < 0:
        raise MemoryError("sym_chunked_csr allocation failed")
    try:
        dstT = np.ctypeslib.as_array(ptr, shape=(8, int(q_total))).copy()
    finally:
        lib.tt_free(ptr)
    return dstT, colstart, deg, deg_orig
