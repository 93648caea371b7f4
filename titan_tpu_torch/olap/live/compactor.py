"""EpochCompactor: fold the delta overlay back into the base CSR (port of
``titan_tpu/olap/live/compactor.py``).

Compaction is the live plane's epoch boundary: the overlay's live adds
and tombstoned base rows are merged into a fresh dst-sorted snapshot,
which the plane republishes; running jobs keep their leased (snapshot,
overlay view) pair.

Two merge implementations:

* **device** (default): the next epoch's chunked CSR is computed on the
  device by ``ops/epoch_merge.merge_chunked_csr`` from the base CSR the
  snapshot caches (``_hybrid_csr_by_device``) and the overlay view, and
  the host snapshot is synced from the delta pages
  (``snapshot.merge_delta``: O(E) memcpy, no sort, no download). Epochs
  are double-buffered through the HBM ledger: the next epoch's CSR
  bytes are reserved BESIDE the current epoch before the merge runs,
  and the merged snapshot is published with its device CSR attached (no
  re-upload).
* **host**: the oracle (filter + concatenate + ``from_arrays``' full
  stable sort), leaving a snapshot with NO device CSR; the next run
  uploads the whole image, which is charged to
  ``serving.live.upload_bytes`` at once. It is the fallback whenever
  the device path cannot run, and every fallback is loud:
  ``serving.live.device_merge_fallbacks`` counts it and ``fallbacks``
  records the reason.

Policy: compact when the overlay's add-buffer fill or its tombstone
fraction crosses its budget (0.5 / 0.05 by default).

The device path runs on ``device`` (``None`` means CUDA): the merge
reads that device's cached chunked CSR, which must lie beside the
overlay's view.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from titan_tpu_torch.device import cache_key
from titan_tpu_torch.olap import snapshot as snap_mod
from titan_tpu_torch.olap.serving.hbm import (AdmissionError,
                                              chunked_csr_bytes,
                                              snapshot_csr_bytes)
from titan_tpu_torch.ops import epoch_merge

#: default thresholds: fill is a fraction of the CURRENT capacity bucket
#: (so small overlays compact before jumping buckets), tombstones a
#: fraction of the base edge rows (dead slots cost gather bandwidth every
#: round until compacted)
MAX_FILL = 0.5
MAX_TOMB_FRACTION = 0.05


class EpochCompactor:
    """Merge policy + merge implementation. Mode and fallback telemetry
    is instance state (one compactor per plane); byte and fallback
    counters go through the ``metrics`` manager passed per call."""

    def __init__(self, max_fill: float = MAX_FILL,
                 max_tomb_fraction: float = MAX_TOMB_FRACTION,
                 *, device_merge: bool = True,
                 verify_device: bool = False, device=None):
        self.max_fill = float(max_fill)
        self.max_tomb_fraction = float(max_tomb_fraction)
        self.device_merge = bool(device_merge)
        # download the device-merged dstT (charged to
        # serving.live.download_bytes) and compare it with the host
        # mirror; a mismatch degrades to the host oracle
        self.verify_device = bool(verify_device)
        self.device = cache_key(device)
        self.device_merges = 0
        self.host_merges = 0
        self.last_mode: str = "none"
        self.fallbacks: dict = {}      # reason -> count

    def policy(self) -> dict:
        """The active policy and the merge-mode telemetry."""
        return {"max_fill": self.max_fill,
                "max_tomb_fraction": self.max_tomb_fraction,
                "device_merge": self.device_merge,
                "verify_device": self.verify_device,
                "merge_mode": self.last_mode,
                "device_merges": self.device_merges,
                "host_merges": self.host_merges,
                "fallbacks": dict(self.fallbacks)}

    def should_compact(self, overlay) -> bool:
        if overlay.count == 0 and overlay.tomb_count == 0:
            return False
        return (overlay.fill_fraction() >= self.max_fill
                or overlay.tombstone_fraction() >= self.max_tomb_fraction)

    # -- host oracle ---------------------------------------------------------

    def merge(self, snapshot, overlay):
        """Base + overlay -> a fresh snapshot over the SAME vertex set, by
        the full stable re-sort on the host; the old snapshot's arrays
        are left untouched. The oracle the device path is held bit-equal
        to, and the fallback it degrades to."""
        keep = ~overlay.tomb_row_mask
        src = snapshot.src[keep]
        dst = snapshot.dst[keep]
        labs = snapshot.labels[keep] if snapshot.labels is not None \
            else None
        a_src, a_dst, a_lab = overlay.live_adds()
        if len(a_src):
            src = np.concatenate([src, a_src])
            dst = np.concatenate([dst, a_dst])
            if labs is not None:
                labs = np.concatenate([labs, a_lab])
        merged = snap_mod.from_arrays(
            snapshot.n, src, dst, snapshot.vertex_ids,
            labels=labs, label_names=snapshot.label_names)
        return self._carry_over(snapshot, merged)

    @staticmethod
    def _carry_over(snapshot, merged):
        # the dense vertex-property columns stay aligned (same vertex
        # set), so values() terminals keep working
        merged.vertex_values = dict(snapshot.vertex_values)
        merged._build_params = dict(snapshot._build_params or {})
        merged.epoch = snapshot.epoch
        return merged

    # -- device path ---------------------------------------------------------

    def _fallback(self, reason: str, metrics) -> None:
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1
        if metrics is not None:
            metrics.counter("serving.live.device_merge_fallbacks").inc()

    def compact(self, snapshot, overlay, *, ledger=None, metrics=None,
                host_only: bool = False, on_resident=None):
        """One epoch boundary: returns ``(merged_snapshot, mode)`` with
        ``mode in ("device", "host")``.

        The device path needs: ``host_only`` False (vertex-set changes
        take the general path, which drops device caches); the base
        chunked CSR cached for this compactor's device and non-empty;
        int32 slot ids for both layouts; and, with a ``ledger``, room
        for the NEXT epoch's CSR beside the current one. Any miss, and
        any exception of the merge, degrades loudly to the host oracle.

        ``on_resident(merged)``, when given, registers the published
        snapshot with the ledger owner's eviction map."""
        if host_only:
            return self._host("apply-path", snapshot, overlay, metrics)
        if not self.device_merge:
            return self._host(None, snapshot, overlay, metrics)
        cache = getattr(snapshot, "_hybrid_csr_by_device", None) or {}
        csr = cache.get(self.device)
        if csr is None:
            return self._host("base-not-resident", snapshot, overlay,
                              metrics)
        if snapshot.num_edges == 0:
            return self._host("empty-base", snapshot, overlay, metrics)
        deg, degc, colstart, q_new = \
            epoch_merge.merged_degrees_host(snapshot, overlay)
        if not (epoch_merge.fits_int32(int(csr["q_total"]))
                and epoch_merge.fits_int32(q_new)):
            return self._host("int32-overflow", snapshot, overlay,
                              metrics)
        reserve_key = None
        nbytes = 0
        if ledger is not None:
            nbytes = chunked_csr_bytes(snapshot.n, q_new)
            reserve_key = ("live-epoch-next", id(self))
            try:
                # the double buffer: the next epoch's CSR beside the
                # current one; a refusal degrades loudly to the host
                ledger.reserve(reserve_key, nbytes)
            except AdmissionError:
                return self._host("ledger-full", snapshot, overlay,
                                  metrics)
        try:
            return self._device(snapshot, overlay, csr, degc, colstart,
                                q_new, ledger, reserve_key, nbytes,
                                metrics, on_resident)
        except Exception as e:
            # ANY failure of the merge degrades to the host oracle (on
            # the card: an allocation the ledger did not predict);
            # letting it escape would leak the pinned reservation and
            # skip the epoch
            if ledger is not None:
                ledger.release(reserve_key)
            return self._host(f"kernel: {type(e).__name__}: {e}",
                              snapshot, overlay, metrics)

    def _device(self, snapshot, overlay, csr, degc, colstart, q_new,
                ledger, reserve_key, nbytes, metrics, on_resident):
        dev = self.device
        view = overlay.view()
        t0 = time.time()
        out = epoch_merge.merge_chunked_csr(
            csr, view, q_total_new=q_new, e_base=snapshot.num_edges)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        device_ms = (time.time() - t0) * 1e3
        # the host-durable sync from delta pages: drop tombstoned rows,
        # insert the adds; no re-sort, no download
        a_src, a_dst, a_lab = overlay.live_adds()
        merged = self._carry_over(snapshot, snap_mod.merge_delta(
            snapshot, ~overlay.tomb_row_mask, a_src, a_dst, a_lab))
        out["_host"] = epoch_merge.LazyHostMirror(merged, colstart, degc)
        if self.verify_device:
            got = out["dstT"].cpu().numpy()
            if metrics is not None:
                metrics.counter("serving.live.download_bytes").inc(
                    got.nbytes)
            if not (got == out["_host"]["dstT"]).all():
                if ledger is not None:
                    ledger.release(reserve_key)
                return self._host("verify-mismatch", snapshot, overlay,
                                  metrics)
        merged._hybrid_csr_by_device[dev] = out
        if ledger is not None:
            # re-key the double-buffer reservation onto the published
            # snapshot: the scheduler's per-run reserve() pins this same
            # entry and its retire path releases it. Resident but
            # unpinned (the warm-cache state) until a job runs
            ledger.release(reserve_key)
            try:
                ledger.reserve(id(merged), nbytes)
                ledger.unpin(id(merged))
            except AdmissionError:
                pass   # the accounting catches up at the next reserve
        if on_resident is not None:
            on_resident(merged)
        if metrics is not None:
            metrics.histogram(
                "serving.live.compact_device_ms").update(device_ms)
        self.device_merges += 1
        self.last_mode = "device"
        return merged, "device"

    def _host(self, fallback_reason, snapshot, overlay, metrics):
        if fallback_reason is not None:
            self._fallback(fallback_reason, metrics)
        merged = self.merge(snapshot, overlay)
        if metrics is not None:
            # the host path leaves no device CSR: the next run uploads
            # the whole image, charged to the epoch now
            metrics.counter("serving.live.upload_bytes").inc(
                snapshot_csr_bytes(merged))
        self.host_merges += 1
        self.last_mode = "host"
        return merged, "host"
