"""The port's native host library (``src/graph500.cpp``): the Graph500
pipeline (``rmat_gen``, ``sym_chunked_csr``) and the store scan's
edge-column codec and counting sort (``parse_heads``, ``bulk_read_uvar``,
the ``KIND_*`` constants, ``csr_build``, ``gather_i32``; copies of
``titan_tpu/native``'s). Built with ``g++`` at first use into
``native/_build/`` and bound with ctypes; a library whose ABI version is
not ``ABI_VERSION`` is refused.

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
ABI_VERSION = 2

#: entry kinds of ``parse_heads``
KIND_SKIP = 0
KIND_OUT_EDGE = 1
KIND_EXISTS = 3


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
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.tt_bulk_read_uvar.restype = i64
    lib.tt_bulk_read_uvar.argtypes = [u8p, i64, i64p, i64p, i64, i64p, i64p]
    lib.tt_parse_heads.restype = i64
    lib.tt_parse_heads.argtypes = [u8p, i64, i64p, i64, u8p, i64, u8p,
                                   i64p, i64p]
    lib.tt_csr_build.restype = None
    lib.tt_csr_build.argtypes = [i32p, i32p, i64, i64, i64p, i64p, i32p,
                                 i64p]
    lib.tt_gather_i32.restype = None
    lib.tt_gather_i32.argtypes = [i32p, i64p, i64, i32p]
    lib.tt_abi_version.restype = ctypes.c_int
    lib.tt_abi_version.argtypes = []
    if lib.tt_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{path} has ABI {lib.tt_abi_version()}, "
                           f"expected {ABI_VERSION}")
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


def bulk_read_uvar(data: np.ndarray, offsets: np.ndarray,
                   bounds: np.ndarray | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Decode one varint at each offset; returns (values, end_offsets).
    ``bounds[i]`` is the end of the entry owning offset i: decoding must
    not cross it (defaults to the end of the buffer)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    m = len(offsets)
    if bounds is None:
        bounds = np.full(m, len(data), dtype=np.int64)
    else:
        bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    if bounds.shape != offsets.shape:
        raise ValueError("offsets and bounds differ in length")
    if m and (int(offsets.min()) < 0 or int(offsets.max()) > len(data)):
        raise ValueError("varint offset outside the buffer")
    values = np.empty(m, dtype=np.int64)
    ends = np.empty(m, dtype=np.int64)
    rc = library().tt_bulk_read_uvar(data, len(data), offsets, bounds, m,
                                     values, ends)
    if rc != m:
        raise ValueError(f"corrupt varint at entry {~rc}")
    return values, ends


def parse_heads(cols: np.ndarray, offs: np.ndarray, exists_prefix: bytes
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Classify each column entry; returns (kind uint8, type_count int64,
    data_pos int64), see the ``KIND_*`` constants."""
    cols = np.ascontiguousarray(cols, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    m = len(offs) - 1
    if m < 0 or (m and (int(offs[0]) < 0 or int(offs[-1]) > len(cols)
                        or bool((np.diff(offs) < 0).any()))):
        raise ValueError("column offsets outside the buffer or not "
                         "ascending")
    kind = np.empty(m, dtype=np.uint8)
    type_count = np.empty(m, dtype=np.int64)
    data_pos = np.empty(m, dtype=np.int64)
    ep = np.frombuffer(exists_prefix, dtype=np.uint8).copy() \
        if exists_prefix else np.empty(0, dtype=np.uint8)
    rc = library().tt_parse_heads(cols, len(cols), offs, m, ep, len(ep),
                                  kind, type_count, data_pos)
    if rc != m:
        raise ValueError(f"corrupt column head at entry {~rc}")
    return kind, type_count, data_pos


def csr_build(src: np.ndarray, dst: np.ndarray, n: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable sort-by-dst permutation + CSR indptr + out-degrees (a
    counting sort, O(E)). Returns (order int64[E], indptr int64[n+1],
    out_degree int32[n]); endpoints must lie in [0, n)."""
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if src.shape != dst.shape:
        raise ValueError("src and dst differ in length")
    e = len(src)
    if e and (min(int(src.min()), int(dst.min())) < 0
              or max(int(src.max()), int(dst.max())) >= n):
        raise ValueError("edge endpoint outside [0, n)")
    order = np.empty(e, dtype=np.int64)
    indptr = np.empty(n + 1, dtype=np.int64)
    out_degree = np.empty(n, dtype=np.int32)
    scratch = np.empty(n + 1, dtype=np.int64)
    library().tt_csr_build(src, dst, e, n, order, indptr, out_degree,
                           scratch)
    return order, indptr, out_degree


def gather_i32(values: np.ndarray, order: np.ndarray) -> np.ndarray:
    """``values[order]`` for an int32 array and an int64 permutation of
    its indices."""
    values = np.ascontiguousarray(values, dtype=np.int32)
    order = np.ascontiguousarray(order, dtype=np.int64)
    if len(order) and (int(order.min()) < 0
                       or int(order.max()) >= len(values)):
        raise ValueError("gather index outside the array")
    out = np.empty(len(order), dtype=np.int32)
    library().tt_gather_i32(values, order, len(order), out)
    return out

