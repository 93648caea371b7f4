"""Live graph plane: serve OLAP traffic while the graph is being written
(the port's copy of ``titan_tpu/olap/live``).

* ``feed.ChangeFeed`` tails the durable user trigger log with a
  resumable named read marker; payloads become columnar ``DeltaBatch``es
  (cross-instance writers reach the plane here; host only);
* ``overlay.DeltaOverlay`` keeps a padded COO add-buffer and a tombstone
  bitmap over base chunked-CSR edge slots beside the resident CSR; the
  batched BFS (``models/bfs_hybrid.frontier_bfs_batched``) and the
  frontier models read the immutable ``OverlayView`` it hands out;
* ``compactor.EpochCompactor`` folds an overlay back into the base at the
  epoch boundary, on the device (``ops/epoch_merge``) or by the host
  oracle;
* ``plane.LiveGraphPlane`` orchestrates them: the in-process listener
  and the feed as two ingest lanes, epoch and lease consistency for
  ``SnapshotPool(live=)`` and ``JobScheduler(live=)``, and the
  ``serving.live.*`` metrics.

Device work lies on the plane's ``device`` (``None`` means CUDA).
"""

from titan_tpu_torch.olap.live.compactor import EpochCompactor
from titan_tpu_torch.olap.live.feed import ChangeFeed, DeltaBatch
from titan_tpu_torch.olap.live.overlay import DeltaOverlay, OverlayView
from titan_tpu_torch.olap.live.plane import LiveGraphPlane

__all__ = ["ChangeFeed", "DeltaBatch", "DeltaOverlay", "OverlayView",
           "EpochCompactor", "LiveGraphPlane"]
