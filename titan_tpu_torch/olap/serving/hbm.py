"""Device-memory (HBM) accounting for graph images — admission's ledger
(the port's copy of ``titan_tpu/olap/serving/hbm.py``).

The serving scheduler admits jobs against it before building a
snapshot's chunked CSR on the device. The byte model is what
``models/bfs_hybrid.build_chunked_csr`` uploads: the transposed
8-aligned ``dstT`` [8, q_total] int32 plus three [n+1] int32 side
arrays (colstart/degc/deg). Eviction is largest-first over unpinned
entries; pinned entries (graphs under a running batch) are never
evicted.

The budget defaults to ``None``: on a CUDA device that is
``DEFAULT_BUDGET_SHARE`` of the card's memory (``torch.cuda.
mem_get_info``), leaving the rest to kernel state and temporaries; on
the CPU there is no device memory to guard and the budget is unbounded.
A mesh-placed cohort charges one device's share
(``meshed_snapshot_csr_bytes``), JAX's model of it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from titan_tpu_torch.device import resolve_device

#: share of a card's memory the default budget lets graph images hold
DEFAULT_BUDGET_SHARE = 0.75


def default_budget_bytes(device=None) -> float:
    """The budget ``None`` stands for on ``device`` (``None`` means
    CUDA): ``DEFAULT_BUDGET_SHARE`` of the card's total memory, or
    unbounded on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return float("inf")
    return DEFAULT_BUDGET_SHARE * torch.cuda.mem_get_info(dev)[1]


def chunked_csr_bytes(n: int, q_total: int) -> int:
    """Device bytes of a chunked CSR: dstT [8, q_total] int32 + 3 x
    [n+1] int32 (colstart/degc/deg)."""
    return q_total * 8 * 4 + 3 * 4 * (n + 1)


def graph_bytes(hg: dict) -> int:
    """Bytes for a host-graph dict (``olap/graph500.load_or_build``)."""
    return chunked_csr_bytes(hg["n"], hg["q_total"])


def snapshot_csr_bytes(snap) -> int:
    """Predicted device bytes of a snapshot's chunked CSR, computable
    BEFORE the build (admission must not pay the upload to learn it
    doesn't fit): q_total = sum(ceil(deg/8)) + 1 pad column."""
    deg = snap.out_degree
    q_total = int((-(-deg.astype("int64") // 8)).sum()) + 1
    return chunked_csr_bytes(snap.n, q_total)


def meshed_snapshot_csr_bytes(snap, num_devices: int) -> int:
    """PER-DEVICE bytes of a mesh-placed chunked CSR
    (``parallel/partition.place_batched_csr``), the JAX package's model:
    the ``dstT`` edge image split over the mesh, each device holding ~1/D
    of it, and the three per-vertex side arrays counted whole. The
    ledger models ONE device's memory, so a mesh-placed cohort charges
    this, not the whole image. It is JAX's model, kept so both ledgers
    charge the same: a port block holds only its own side arrays, and
    its column count follows the cuts."""
    total = snapshot_csr_bytes(snap)
    n = getattr(snap, "n", 0)
    vert = 3 * 4 * (n + 1)                    # colstart/degc/deg
    edges = max(total - vert, 0)
    return int(vert + -(-edges // max(int(num_devices), 1)))


class AdmissionError(RuntimeError):
    """The job's graph image cannot fit the budget even after evicting
    every unpinned resident graph."""


class HBMLedger:
    """Budgeted accounting of device-resident graph images.

    ``reserve(key, nbytes)`` charges an entry, evicting largest-first
    among unpinned entries until it fits (``on_evict(key)`` lets the
    owner drop the device tensors; the memory frees when the last
    reference dies). Raises AdmissionError when even a full sweep cannot
    make room. Entries are pinned while reserved; ``unpin`` leaves them
    resident-but-evictable (the warm-cache state), ``release`` drops
    them entirely. ``budget_bytes=None`` resolves through
    ``default_budget_bytes(device)``."""

    def __init__(self, budget_bytes: Optional[float] = None,
                 on_evict: Optional[Callable[[object], None]] = None,
                 device=None):
        if budget_bytes is None:
            budget_bytes = default_budget_bytes(device)
        self.budget_bytes = float(budget_bytes)
        self._on_evict = on_evict
        self._bytes: dict = {}
        self._pins: dict = {}
        self._lock = threading.Lock()

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(self._bytes.values())

    def pinned_bytes(self) -> int:
        """Bytes held by PINNED entries (graphs under a running batch)
        — the unevictable share of ``resident_bytes``; exported as the
        ``serving.hbm.pinned_bytes`` gauge."""
        with self._lock:
            return sum(b for k, b in self._bytes.items()
                       if self._pins.get(k, 0) > 0)

    def reserve(self, key, nbytes: int) -> None:
        evicted = []
        with self._lock:
            if key in self._bytes:
                self._pins[key] = self._pins.get(key, 0) + 1
                return
            pinned = sum(self._bytes[k] for k, c in self._pins.items()
                         if c > 0)
            if pinned + nbytes > self.budget_bytes:
                raise AdmissionError(
                    f"admission: graph image needs {nbytes/1e9:.2f}GB "
                    f"but only {max(self.budget_bytes - pinned, 0)/1e9:.2f}"
                    f"GB of the {self.budget_bytes/1e9:.2f}GB device "
                    "memory budget is free of pinned (in-use) graphs")
            # evict largest unpinned until the new entry fits
            while sum(self._bytes.values()) + nbytes > self.budget_bytes:
                victims = {k: b for k, b in self._bytes.items()
                           if self._pins.get(k, 0) == 0}
                if not victims:
                    raise AdmissionError(
                        "admission: device memory budget exhausted by "
                        "pinned graphs")
                victim = max(victims, key=victims.get)
                self._bytes.pop(victim)
                self._pins.pop(victim, None)
                evicted.append(victim)
            self._bytes[key] = int(nbytes)
            self._pins[key] = 1
        for k in evicted:
            if self._on_evict is not None:
                self._on_evict(k)

    def unpin(self, key) -> None:
        with self._lock:
            if key in self._pins and self._pins[key] > 0:
                self._pins[key] -= 1

    def release(self, key) -> None:
        with self._lock:
            self._bytes.pop(key, None)
            self._pins.pop(key, None)


class DeviceGraphCache:
    """Stage-shared device-graph cache: ``get_or_load(key, host_loader,
    uploader)`` returns ``(host_graph, device_graph, gen_s, upload_s)``,
    keeping every loaded graph resident and evicting largest-first only
    when a new graph would overflow the budget."""

    def __init__(self, budget_bytes: Optional[float] = None, device=None):
        self._ledger = HBMLedger(budget_bytes, on_evict=self._drop,
                                 device=device)
        self._graphs: dict = {}
        self._lock = threading.Lock()

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def _drop(self, key) -> None:
        self._graphs.pop(key, None)

    def get_or_load(self, key, host_loader, uploader):
        with self._lock:
            got = self._graphs.get(key)
            if got is not None:
                return got + (0.0, 0.0)
            t0 = time.time()
            hg = host_loader()
            gen_s = time.time() - t0
            self._ledger.reserve(key, graph_bytes(hg))
            self._ledger.unpin(key)   # resident-but-evictable
            t0 = time.time()
            g = uploader(hg)
            upload_s = time.time() - t0
            self._graphs[key] = (hg, g)
            return hg, g, gen_s, upload_s
