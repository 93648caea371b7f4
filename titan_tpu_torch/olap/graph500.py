"""Graph500 benchmark-graph pipeline: generate, build, cache, upload
(port of ``titan_tpu/olap/tpu/graph500.py``).

The graph is generated and CSR-built on the host (``native``: R-MAT plus
the symmetrized, deduplicated 8-aligned chunked CSR, or the numpy path
when asked for), cached on disk, and uploaded once. At scale 26 the
symmetrized graph has 2^31 directed edges, one past the int32 limit, so
the CSR build dedups each vertex's adjacency and drops self-loops, as
Graph500 implementations do; TEPS still counts the PRE-dedup degrees
(``deg_orig``), per the Graph500 TEPS definition.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from titan_tpu_torch.device import resolve_device

DEFAULT_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".bench_cache", "torch")
GENERATORS = ("native", "numpy")
_ARRAYS = ("dstT", "colstart", "deg", "deg_orig")


def load_or_build(scale: int, edge_factor: int = 16, seed: int = 2,
                  cache_dir: str | None = None, verbose: bool = True,
                  generator: str = "native") -> dict:
    """Host-side chunked Graph500 CSR, disk-cached per generator.

    Returns a numpy dict: ``dstT`` int32 [8, Q] (transposed 8-aligned
    chunked CSR, pad = n+1), ``colstart`` int32 [n+1], ``deg`` int32 [n]
    (post-dedup), ``deg_orig`` int32 [n], plus ``n``, ``q_total``,
    ``m_input`` and the build parameters. The two generators give
    different edge sets for one seed; ``native`` raises if its library
    cannot be built."""
    if generator not in GENERATORS:
        raise ValueError(f"generator={generator!r}: expected one of "
                         f"{GENERATORS}")
    cache_dir = cache_dir or DEFAULT_CACHE
    tag = f"g500_s{scale}_ef{edge_factor}_seed{seed}_{generator}"
    meta_path = os.path.join(cache_dir, tag + ".json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            out = json.load(f)
        out.update({k: np.load(os.path.join(cache_dir, f"{tag}_{k}.npy"),
                               mmap_mode="r") for k in _ARRAYS})
        return out

    n = 1 << scale
    m = n * edge_factor
    t0 = time.time()
    if generator == "native":
        from titan_tpu_torch import native
        src, dst = native.rmat_gen(m, scale, seed=seed)
        t1 = time.time()
        dstT, colstart64, deg, deg_orig = native.sym_chunked_csr(src, dst, n)
    else:
        from titan_tpu_torch.olap.rmat import rmat_edges
        src, dst = rmat_edges(scale, edge_factor, seed=seed)
        t1 = time.time()
        flat, colstart64, deg, deg_orig = _sym_chunked_csr_numpy(src, dst, n)
        dstT = np.ascontiguousarray(flat.T)
        del flat
    del src, dst
    t2 = time.time()
    q_total = dstT.shape[1]
    # the kernels index COLUMNS (q_total) and vertices, never flat slot
    # positions, so int32 needs q_total < 2^31 (scale 26: ~282M columns)
    if q_total >= (1 << 31):
        raise NotImplementedError(
            f"chunked CSR has {q_total} columns >= 2^31; needs sharding")
    colstart = colstart64.astype(np.int32)
    if verbose:
        print(f"graph500 s{scale} ({generator}): gen {t1-t0:.1f}s "
              f"build {t2-t1:.1f}s q_total={q_total}")
    meta = {"n": n, "q_total": int(q_total), "m_input": m,
            "generator": generator, "scale": scale,
            "edge_factor": edge_factor, "seed": seed,
            "e_dedup": int(deg.sum(dtype=np.int64)),
            "e_sym": int(deg_orig.sum(dtype=np.int64))}
    out = {"dstT": dstT, "colstart": colstart, "deg": deg,
           "deg_orig": deg_orig}
    os.makedirs(cache_dir, exist_ok=True)
    for k in _ARRAYS:
        np.save(os.path.join(cache_dir, f"{tag}_{k}.npy"), out[k])
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    out.update(meta)
    return out


def _sym_chunked_csr_numpy(src, dst, n: int):
    """Numpy mirror of native.sym_chunked_csr (symmetrize, per-vertex
    sort-dedup incl. self-loop drop, 8-aligned chunk layout). Returns the
    chunk-major ``flat`` [q_total, 8] like the JAX package's version."""
    v = np.concatenate([src, dst]).astype(np.int64)
    w = np.concatenate([dst, src]).astype(np.int64)
    deg_orig = np.bincount(v, minlength=n).astype(np.int32)
    packed = np.unique(v * (n + 1) + w)
    pv = (packed // (n + 1)).astype(np.int64)
    pw = (packed % (n + 1)).astype(np.int64)
    keep = pv != pw
    pv, pw = pv[keep], pw[keep]
    deg = np.bincount(pv, minlength=n).astype(np.int32)
    degc = -(-deg.astype(np.int64) // 8)
    colstart64 = np.zeros(n + 1, np.int64)
    np.cumsum(degc, out=colstart64[1:])
    q_total = int(colstart64[-1]) + 1
    flat = np.full(q_total * 8, n + 1, np.int32)
    starts8 = colstart64[:n] * 8
    pos = np.repeat(starts8 - np.concatenate(
        [[0], np.cumsum(deg.astype(np.int64))])[:n], deg) \
        + np.arange(len(pw), dtype=np.int64)
    flat[pos] = pw
    return flat.reshape(q_total, 8), colstart64, deg, deg_orig


def _upload_rows(arr, dev: torch.device, chunk: int = 1 << 24):
    """[R, Q] host array -> device tensor. On a card each row is copied
    in ``chunk``-column pieces through two pinned staging buffers, so a
    memory-mapped cache pages in while the previous piece is in flight."""
    if dev.type != "cuda":
        return torch.from_numpy(np.array(arr))
    rows, cols = arr.shape
    dtype = torch.from_numpy(np.empty(0, dtype=arr.dtype)).dtype
    out = torch.empty((rows, cols), dtype=dtype, device=dev)
    chunk = min(chunk, max(cols, 1))
    stage = [torch.empty(chunk, dtype=dtype, pin_memory=True)
             for _ in range(2)]
    done = [None, None]
    i = 0
    for r in range(rows):
        for c0 in range(0, cols, chunk):
            c1 = min(c0 + chunk, cols)
            b = i % 2
            if done[b] is not None:
                done[b].synchronize()
            stage[b][:c1 - c0].numpy()[:] = arr[r, c0:c1]
            out[r, c0:c1].copy_(stage[b][:c1 - c0], non_blocking=True)
            done[b] = torch.cuda.Event()
            done[b].record()
            i += 1
    torch.cuda.current_stream(dev).synchronize()
    return out


def graph_from_numpy(host_graph: dict, device=None) -> dict:
    """Host chunked-CSR arrays -> the device dict ``frontier_bfs_hybrid``
    takes (``dstT``, ``colstart``, ``degc`` [n+1] with a trailing 0,
    ``q_total``, ``n``, and ``deg`` [n+1] when the host graph has
    ``deg``); the port of the JAX package's ``to_device``.
    Accepts a ``load_or_build`` result or the JAX package's
    ``build_chunked_csr(snap)["_host"]`` arrays, so both packages can run
    on the very same graph."""
    dev = resolve_device(device)
    colstart = np.asarray(host_graph["colstart"]).astype(np.int32)
    n = colstart.shape[0] - 1
    if "degc" in host_graph:
        degc = np.asarray(host_graph["degc"]).astype(np.int32)
    else:
        deg = np.asarray(host_graph["deg"]).astype(np.int64)
        degc = np.concatenate([-(-deg // 8), [0]]).astype(np.int32)
    dstT = host_graph["dstT"]
    out = {"dstT": _upload_rows(dstT, dev),
           "colstart": torch.from_numpy(colstart).to(dev),
           "degc": torch.from_numpy(degc).to(dev),
           "q_total": int(dstT.shape[1]), "n": n}
    if "deg" in host_graph:
        out["deg"] = torch.from_numpy(np.concatenate(
            [np.asarray(host_graph["deg"]), [0]]).astype(np.int32)).to(dev)
    return out


def device_degrees(deg_orig: np.ndarray, device=None) -> torch.Tensor:
    """Upload (once) the pre-dedup degrees for ``reachable_edge_sum``."""
    return torch.from_numpy(
        np.asarray(deg_orig, np.int32).copy()).to(resolve_device(device))


def reachable_edge_sum(dist, deg_orig, inf: int, deg_dev=None
                       ) -> tuple[int, int]:
    """Graph500 TEPS numerator: the sum of PRE-dedup degrees over the
    reachable vertices, and the reachable count. Summed in int64 on
    ``dist``'s device; equal to the JAX package's per-chunk int32 partial
    sums added on the host."""
    dist = torch.as_tensor(dist)
    n = len(deg_orig)
    if deg_dev is None:
        deg_dev = device_degrees(deg_orig, dist.device)
    reach = dist[:n] < inf
    m2 = torch.where(reach, deg_dev, 0).sum(dtype=torch.int64)
    m2, nreach = torch.stack([m2, reach.sum(dtype=torch.int64)]).tolist()
    return int(m2), int(nreach)
