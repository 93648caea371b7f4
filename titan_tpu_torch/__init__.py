"""PyTorch/CUDA port of titan_tpu for NVIDIA Hopper.

The JAX package ``titan_tpu`` stays the reference; this package imports
nothing of it. Entry points take ``device=None``, which means CUDA and
raises when no card is present; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels on the host.

The graph entry point is the reference's (``titan_tpu/__init__.py``),
over the port's own copy of the OLTP spine, the in-memory and sqlite
stores, the write-ahead log and the change-log processors:

    import titan_tpu_torch
    g = titan_tpu_torch.open("inmemory")
    computer = g.compute(device="cpu")      # GPUGraphComputer; None = CUDA
"""

__version__ = "0.1.0"

from titan_tpu_torch import errors


def open(config):  # noqa: A001  (deliberate builtin shadow, package-level)
    """Open a graph: a backend shorthand (``"inmemory"``), a dotted-path
    dict or a ``Configuration``. The ``inmemory`` and ``sqlite`` stores
    are ported."""
    from titan_tpu_torch.factory import open_graph
    return open_graph(config)


def open_log_processors(graph):
    """Change-stream framework over the graph's user trigger logs
    (reference: TitanFactory.openTransactionLog → LogProcessorFramework)."""
    from titan_tpu_torch.core.changes import LogProcessorFramework
    return LogProcessorFramework(graph)


__all__ = ["open", "open_log_processors", "errors", "__version__"]
