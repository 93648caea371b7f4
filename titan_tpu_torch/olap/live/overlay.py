"""DeltaOverlay: a device COO add-buffer and base-edge tombstones (port of
``titan_tpu/olap/live/overlay.py``).

The overlay keeps the base chunked-CSR device arrays untouched and
layers a delta beside them:

* **adds**: a padded COO buffer ``(src, dst)`` of dense indices (pad =
  ``n+1``, the batched BFS's spare column), sized in power-of-two
  capacity buckets;
* **tombstones**: a bitmap over base edge SLOTS in the chunked-CSR
  layout (slot = column*8 + lane, byte = column, as
  ``models/bfs_hybrid.build_chunked_csr`` lays them out): a masked slot
  stops counting as a parent in the overlay-aware sweep.

``view()`` ships only the changed bytes to the device: the appended row
range (plus any rows killed in place) and the dirtied tombstone bytes.
Buffer establishment and capacity growth are fills on the device. Every
byte that does cross from the host (payloads and the int32 index words of
the scatters) is counted on ``serving.live.upload_bytes`` when a
``metrics`` manager is attached (duck-typed:
``metrics.counter(name).inc(k)``). The JAX package also mirrors that
count onto its device profiler (``obs/devprof``); the port's profiler
belongs to the serving slice, so that mirror is not ported.

Views are immutable. JAX's ``.at[].set`` returns new arrays, so a view
frozen by ``view()`` never changes when the overlay appends later. In
torch an in-place write into the resident buffers would rewrite every
view already handed out, so ``view()`` writes copy-on-write: a buffer
that an earlier view holds is copied before the scatter; only a buffer
made in the same call is written in place.

Device accounting: ``device_bytes()`` (2·4·cap + q_total) is reserved
through a ``ledger`` when one is attached (duck-typed:
``reserve(key, nbytes)`` / ``release(key)``).

The overlay assumes external synchronisation (the JAX package's live
plane owns and locks it).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from titan_tpu_torch.device import next_pow2, resolve_device

#: smallest add-buffer capacity bucket (power of two)
MIN_CAP = 1024


class OverlayView:
    """Immutable device-side view of the overlay at one delta seq."""

    __slots__ = ("n", "cap", "count", "src_dev", "dst_dev", "tomb_dev",
                 "tomb_count", "seq", "slot_base")

    def __init__(self, n, cap, count, src_dev, dst_dev, tomb_dev,
                 tomb_count, seq, slot_base):
        self.n = n
        self.cap = cap
        self.count = count
        self.src_dev = src_dev
        self.dst_dev = dst_dev
        self.tomb_dev = tomb_dev
        self.tomb_count = tomb_count
        self.seq = seq
        self.slot_base = slot_base

    @property
    def empty(self) -> bool:
        return self.count == 0 and self.tomb_count == 0

    @property
    def has_tombstones(self) -> bool:
        return self.tomb_count > 0


class DeltaOverlay:
    """See the module doc. Built against ONE base snapshot (duck-typed:
    ``n``, ``out_degree``, ``out_csr()``, ``num_edges``, ``labels``,
    ``src``); views lie on ``device`` (``None`` means CUDA)."""

    def __init__(self, snapshot, *, min_cap: int = MIN_CAP,
                 ledger=None, ledger_key=None, metrics=None, device=None):
        self.device = resolve_device(device)
        self.snap = snapshot
        self.n = int(snapshot.n)
        deg = snapshot.out_degree.astype(np.int64)
        degc = -(-deg // 8)
        colstart = np.zeros(self.n + 1, np.int64)
        np.cumsum(degc, out=colstart[1:])
        # q_total matches models/bfs_hybrid.build_chunked_csr exactly:
        # slot ids must agree with the device layout (+1 pad column)
        self.q_total = int(colstart[-1]) + 1
        self._colstart = colstart
        self._deg = deg
        # out-CSR host view for the slot lookup on removals
        self._dst_by_src, self._indptr_out = snapshot.out_csr()
        self._labels_by_src: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None
        # add buffer: host mirror; the device buffers are made by view()
        self.cap = int(min_cap)
        self._min_cap = int(min_cap)
        self._h_src = np.full(self.cap, self.n + 1, np.int32)
        self._h_dst = np.full(self.cap, self.n + 1, np.int32)
        self._h_lab = np.zeros(self.cap, np.int32)
        self.count = 0
        self.dead_adds = 0             # appended rows later tombstoned
        # tombstones: slot bitmap (device mirror) and a per-base-ROW mask
        # (host only: the compactor filters snapshot rows with it)
        self._h_tomb = np.zeros(self.q_total, np.uint8)
        self.tomb_row_mask = np.zeros(snapshot.num_edges, bool)
        self.tomb_count = 0
        self.seq = 0                   # bumps on every mutation
        # rows [0, _clean_rows) of the device add buffers are current;
        # rows killed in place below that watermark collect in
        # _dirty_add_rows, and set bitmap bytes in _dirty_tomb_bytes
        self._d_src: Optional[torch.Tensor] = None
        self._d_dst: Optional[torch.Tensor] = None
        self._d_tomb: Optional[torch.Tensor] = None
        self._clean_rows = 0
        self._dirty_add_rows: set = set()
        self._dirty_tomb_bytes: set = set()
        self._metrics = metrics
        self._ledger = ledger
        self._ledger_key = ledger_key if ledger_key is not None \
            else ("live-overlay", id(self))
        self._reserved = 0
        self._reserve()

    # -- device accounting ---------------------------------------------------

    def device_bytes(self) -> int:
        return 2 * 4 * self.cap + self.q_total

    def _reserve(self) -> None:
        if self._ledger is None:
            return
        need = self.device_bytes()
        if need == self._reserved:
            return
        self._ledger.release(self._ledger_key)
        self._ledger.reserve(self._ledger_key, need)  # stays pinned
        self._reserved = need

    def close(self) -> None:
        if self._ledger is not None:
            self._ledger.release(self._ledger_key)
            self._reserved = 0

    # -- mutation ------------------------------------------------------------

    def _grow(self, need: int) -> None:
        new_cap = next_pow2(max(need, self._min_cap))
        if new_cap <= self.cap:
            return
        for name in ("_h_src", "_h_dst", "_h_lab"):
            old = getattr(self, name)
            fill = self.n + 1 if name != "_h_lab" else 0
            fresh = np.full(new_cap, fill, np.int32)
            fresh[:self.count] = old[:self.count]
            setattr(self, name, fresh)
        self.cap = new_cap    # the device buffers pad-extend at view()
        self._reserve()       # a ledger may refuse the growth

    def append_edges(self, src_dense, dst_dense, labs) -> int:
        """Append dense-index edge rows (the caller symmetrizes for
        undirected snapshots). Returns the rows appended."""
        src_dense = np.asarray(src_dense, np.int32)
        dst_dense = np.asarray(dst_dense, np.int32)
        labs = np.asarray(labs, np.int32)
        k = len(src_dense)
        if k == 0:
            return 0
        if self.count + k > self.cap:
            self._grow(self.count + k)
        sl = slice(self.count, self.count + k)
        self._h_src[sl] = src_dense
        self._h_dst[sl] = dst_dense
        self._h_lab[sl] = labs
        self.count += k          # the [_clean_rows, count) tail is the
        self.seq += 1            # delta page view() scatters
        return k

    def _labels_src_order(self) -> Optional[np.ndarray]:
        if self.snap.labels is None:
            return None
        if self._labels_by_src is None:
            self._labels_by_src = self.snap.labels[self._base_order()]
        return self._labels_by_src

    def _base_order(self) -> np.ndarray:
        """The src-order permutation of the base rows (slot -> dst-order
        row), which the snapshot caches beside its out-CSR."""
        if self._order is None:
            order = getattr(self.snap, "_out_csr_order", None)
            if order is None:
                self.snap.out_csr()
                order = getattr(self.snap, "_out_csr_order", None)
            self._order = order if order is not None \
                else np.argsort(self.snap.src, kind="stable")
        return self._order

    def remove_edge(self, u: int, v: int, lab: Optional[int]) -> bool:
        """Tombstone ONE live row (u->v[, label]): first a base-CSR slot,
        else a live overlay add. Returns False when no live row matches
        (a rebuild would not see the edge either)."""
        labs_src = self._labels_src_order()
        p0 = int(self._indptr_out[u])
        p1 = p0 + int(self._deg[u])
        for p in range(p0, p1):
            if int(self._dst_by_src[p]) != v:
                continue
            if lab is not None and labs_src is not None \
                    and int(labs_src[p]) != lab:
                continue
            slot = int(self._colstart[u]) * 8 + (p - p0)
            byte, bit = slot >> 3, slot & 7
            if self._h_tomb[byte] & (1 << bit):
                continue               # this row is already dead
            self._h_tomb[byte] |= (1 << bit)
            self._dirty_tomb_bytes.add(byte)
            self.tomb_row_mask[self._base_order()[p]] = True
            self.tomb_count += 1
            self.seq += 1
            return True
        # not in the base: kill a live overlay add
        for i in range(self.count):
            if int(self._h_src[i]) == u and int(self._h_dst[i]) == v \
                    and (lab is None or int(self._h_lab[i]) == lab):
                self._h_src[i] = self.n + 1
                self._h_dst[i] = self.n + 1
                self.dead_adds += 1
                if i < self._clean_rows:
                    self._dirty_add_rows.add(i)
                self.seq += 1
                return True
        return False

    # -- observation ---------------------------------------------------------

    def fill_fraction(self) -> float:
        return self.count / max(self.cap, 1)

    def tombstone_fraction(self) -> float:
        return self.tomb_count / max(self.snap.num_edges, 1)

    def live_adds(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, lab) dense host arrays of the LIVE appended rows
        (killed rows excluded): the compactor's merge input."""
        s = self._h_src[:self.count]
        alive = s <= self.n
        return (s[alive].copy(), self._h_dst[:self.count][alive].copy(),
                self._h_lab[:self.count][alive].copy())

    def stats(self) -> dict:
        return {"capacity": self.cap, "adds": self.count,
                "dead_adds": self.dead_adds,
                "tombstones": self.tomb_count,
                "fill": round(self.fill_fraction(), 4),
                "tombstone_fraction":
                    round(self.tombstone_fraction(), 6),
                "device_bytes": self.device_bytes(), "seq": self.seq}

    # -- device sync / views -------------------------------------------------

    def _count_upload(self, nbytes: int) -> None:
        if self._metrics is not None and nbytes:
            self._metrics.counter("serving.live.upload_bytes") \
                .inc(int(nbytes))

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(host)).to(self.device)

    def view(self) -> OverlayView:
        """Freeze the current state into an immutable device view. Only
        the delta pages cross to the device: the appended tail (plus rows
        killed in place) and the dirtied tombstone bytes; every byte that
        does counts on ``serving.live.upload_bytes``. A buffer that an
        earlier view holds is copied before it is written (see the module
        doc)."""
        dev, pad = self.device, self.n + 1
        fresh_adds = False
        if self._d_src is None:
            # a fill on the device: 0 bytes uploaded; the scatter below
            # ships rows [0, count), the actual delta
            self._d_src = torch.full((self.cap,), pad, dtype=torch.int32,
                                     device=dev)
            self._d_dst = torch.full((self.cap,), pad, dtype=torch.int32,
                                     device=dev)
            self._clean_rows = 0
            fresh_adds = True
        elif self._d_src.shape[0] != self.cap:
            # the capacity bucket grew: pad-extend on the device (a new
            # tensor, so earlier views keep theirs); resident rows stay
            ext = torch.full((self.cap - self._d_src.shape[0],), pad,
                             dtype=torch.int32, device=dev)
            self._d_src = torch.cat([self._d_src, ext])
            self._d_dst = torch.cat([self._d_dst, ext])
            fresh_adds = True
        if self._dirty_add_rows or self._clean_rows < self.count:
            rows = sorted(self._dirty_add_rows)
            rows.extend(range(self._clean_rows, self.count))
            # int32 index words cross; the widening is on the device
            idx = self._upload(np.asarray(rows, np.int32)).long()
            vals = (self._upload(self._h_src[rows]),
                    self._upload(self._h_dst[rows]))
            if fresh_adds:
                self._d_src.index_copy_(0, idx, vals[0])
                self._d_dst.index_copy_(0, idx, vals[1])
            else:               # copy-on-write: a view holds these
                self._d_src = self._d_src.index_copy(0, idx, vals[0])
                self._d_dst = self._d_dst.index_copy(0, idx, vals[1])
            self._clean_rows = self.count
            self._dirty_add_rows.clear()
            # 2 int32 payloads + the int32 index word a row (shipped
            # once, used by both scatters)
            self._count_upload((2 * 4 + 4) * len(rows))
        fresh_tomb = False
        if self._d_tomb is None:
            # all-zero bitmap: a fill on the device (every byte set since
            # construction is in _dirty_tomb_bytes)
            self._d_tomb = torch.zeros((self.q_total,), dtype=torch.uint8,
                                       device=dev)
            fresh_tomb = True
        if self._dirty_tomb_bytes:
            idx_h = np.fromiter(self._dirty_tomb_bytes, np.int64,
                                len(self._dirty_tomb_bytes))
            idx = self._upload(idx_h.astype(np.int32)).long()
            val = self._upload(self._h_tomb[idx_h])
            if fresh_tomb:
                self._d_tomb.index_copy_(0, idx, val)
            else:               # copy-on-write: a view holds it
                self._d_tomb = self._d_tomb.index_copy(0, idx, val)
            self._dirty_tomb_bytes.clear()
            # 1 payload byte + 4 index bytes per dirtied bitmap byte
            self._count_upload(5 * len(idx_h))
        return OverlayView(self.n, self.cap, self.count, self._d_src,
                           self._d_dst, self._d_tomb, self.tomb_count,
                           self.seq, slot_base=self.q_total * 8)
