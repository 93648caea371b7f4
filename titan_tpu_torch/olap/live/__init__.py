"""Live graph plane, device side (port of the device view, the add /
tombstone buffer and the epoch compactor of ``titan_tpu/olap/live``).

``overlay.DeltaOverlay`` keeps a padded COO add-buffer and a tombstone
bitmap over base-CSR edge slots beside the resident chunked CSR; the
batched BFS (``models/bfs_hybrid.frontier_bfs_batched``) reads the
immutable ``OverlayView`` it hands out. ``compactor.EpochCompactor``
folds an overlay back into the base at the epoch boundary, on the device
(``ops/epoch_merge``) or by the host oracle. The change feed and the
plane's orchestration (``feed.py``, ``plane.py``) are not ported yet
(ROADMAP queue 1, item 8).
"""

from titan_tpu_torch.olap.live.compactor import EpochCompactor
from titan_tpu_torch.olap.live.overlay import DeltaOverlay, OverlayView

__all__ = ["DeltaOverlay", "EpochCompactor", "OverlayView"]
