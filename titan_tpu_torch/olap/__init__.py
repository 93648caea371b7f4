"""The port's OLAP layer: the engine (``engine.py``), snapshots
(``snapshot.py``), the bulk loader (``bulk.py``) and serving."""


def graph_computer(graph, backend: str = "gpu", **kwargs):
    """``graph.compute()`` dispatch (the counterpart of
    ``titan_tpu/olap/__init__.py``): ``backend="gpu"`` is the superstep
    engine on one card, ``GPUGraphComputer(graph, **kwargs)``; the JAX
    package's ``host`` and ``tpu`` computers are not ported."""
    if backend == "gpu":
        from titan_tpu_torch.olap.engine import GPUGraphComputer
        return GPUGraphComputer(graph, **kwargs)
    if backend in ("host", "tpu"):
        from titan_tpu_torch.errors import not_ported
        raise not_ported(f"computer.backend={backend!r}")
    raise ValueError(f"unknown computer backend {backend!r}")


__all__ = ["graph_computer"]
