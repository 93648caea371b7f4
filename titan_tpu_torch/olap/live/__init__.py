"""Live graph plane, device side (port of the device view and the add /
tombstone buffer of ``titan_tpu/olap/live``).

``overlay.DeltaOverlay`` keeps a padded COO add-buffer and a tombstone
bitmap over base-CSR edge slots beside the resident chunked CSR; the
batched BFS (``models/bfs_hybrid.frontier_bfs_batched``) reads the
immutable ``OverlayView`` it hands out. The change feed, the compactor
and the plane's orchestration are not ported yet.
"""

from titan_tpu_torch.olap.live.overlay import DeltaOverlay, OverlayView

__all__ = ["DeltaOverlay", "OverlayView"]
