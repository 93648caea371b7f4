"""The port's OLAP layer: the engine (``engine.py``), snapshots
(``snapshot.py``), the bulk loader (``bulk.py``), serving, the host
computer (``computer.py``) and the scan framework's jobs and split runners
(``jobs.py``, ``distributed.py``, ``scan_worker.py``)."""

from titan_tpu_torch.olap.api import (DenseProgram, Memory, Messenger,
                                      ScanJob, ScanMetrics, VertexProgram,
                                      VertexScanJob)


def graph_computer(graph, backend: str = "gpu", **kwargs):
    """``graph.compute()`` dispatch (the counterpart of
    ``titan_tpu/olap/__init__.py``): ``backend="gpu"`` is the superstep
    engine, ``GPUGraphComputer(graph, **kwargs)``;
    ``backend="host"`` is the thread-pool host executor,
    ``HostGraphComputer(graph, **kwargs)``. The JAX package's ``tpu``
    computer is not ported."""
    if backend == "gpu":
        from titan_tpu_torch.olap.engine import GPUGraphComputer
        return GPUGraphComputer(graph, **kwargs)
    if backend == "host":
        from titan_tpu_torch.olap.computer import HostGraphComputer
        return HostGraphComputer(graph, **kwargs)
    if backend == "tpu":
        from titan_tpu_torch.errors import not_ported
        raise not_ported(f"computer.backend={backend!r}")
    raise ValueError(f"unknown computer backend {backend!r}")


__all__ = ["DenseProgram", "Memory", "Messenger", "ScanJob", "ScanMetrics",
           "VertexProgram", "VertexScanJob", "graph_computer"]
