"""The superstep checkpoint and recovery plane of the port (a copy of
``titan_tpu/olap/recovery/``: numpy and the standard library only).

* ``store``      — versioned on-disk checkpoints: a manifest with a
                   sha256 digest an array, written last, and an atomic
                   rename-commit; ``latest()`` returns the newest one
                   that validates. The format (``FORMAT_VERSION`` 1,
                   ``<root>/<job_id>/ckpt-a0001-r00000012/``, one
                   ``.npy`` an array) is the JAX package's, so each
                   package resumes from the other's checkpoints.
* ``checkpoint`` — ``JobRecovery``: a job's cadence, faults and metrics.
* ``faults``     — the deterministic injector (crash, evict, corrupt,
                   slow write).

The engine's checkpointed run is ``olap/engine.run_single(...,
checkpoint=, checkpoint_every=, resume=)`` and
``GPUGraphComputer.run(resume_from=, checkpoint_to=,
checkpoint_every=)``.
"""

from titan_tpu_torch.olap.recovery.checkpoint import JobRecovery  # noqa: F401
from titan_tpu_torch.olap.recovery.faults import (FaultPlan,      # noqa: F401
                                                  InjectedFault,
                                                  SnapshotEvicted)
from titan_tpu_torch.olap.recovery.store import (Checkpoint,      # noqa: F401
                                                 CheckpointInvalid,
                                                 CheckpointStore, Counters)
