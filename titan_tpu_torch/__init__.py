"""PyTorch/CUDA port of titan_tpu's Graph500 BFS path for NVIDIA Hopper.

The JAX package ``titan_tpu`` stays the reference; this package imports
nothing of it. Entry points take ``device=None``, which means CUDA and
raises when no card is present; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels on the host.
"""
