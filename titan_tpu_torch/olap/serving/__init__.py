"""The serving layer of the port: concurrent job scheduling and
multi-source batching on one card (the port's copy of
``titan_tpu/olap/serving``).

* ``jobs``      — job/handle lifecycle (queued → running → terminal).
* ``pool``      — the snapshot pool: jobs lease one ``GraphSnapshot``
                  per parameter set, built from the graph and refreshed
                  by epoch, or one fixed snapshot.
* ``hbm``       — device-memory accounting backing admission: the
                  chunked CSR's bytes against a budget, largest-first
                  eviction of idle graph images.
* ``batcher``   — multi-source fusion: same-snapshot BFS jobs run as one
                  ``[K, n]`` batched run
                  (models/bfs_hybrid.frontier_bfs_batched), SSSP/WCC
                  jobs as cohorts; PageRank, DensePrograms and host
                  callables alone.
* ``scheduler`` — priority queue + admission + worker thread, with
                  per-job latency / queue-depth / batch-occupancy metrics
                  through utils/metrics, recovery from checkpoints
                  (olap/recovery), tracing, flight recorder and device
                  profiling (titan_tpu_torch/obs).
* ``autotune``  — the closed-loop decision plane: a per-scheduler
                  Controller journals bounded knob decisions (shadow by
                  default).
* ``tenants``   — per-tenant attribution and quota admission.
* ``interactive`` — the point-query lane behind
                  ``JobScheduler.interactive()``: bounded chains fused
                  into one hops batch, personalized PageRank.

``JobScheduler(snapshot=..., device=None)`` runs on CUDA and raises
without a card; pass ``device="cpu"`` for the plain PyTorch path.
"""

from titan_tpu_torch.olap.serving.jobs import Job, JobState  # noqa: F401
from titan_tpu_torch.olap.serving.scheduler import (  # noqa: F401
    JobScheduler)
from titan_tpu_torch.olap.serving.tenants import (  # noqa: F401
    DEFAULT_TENANT, QuotaExceeded, TenantQuota)
