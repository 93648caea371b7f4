"""The benchmark of ``titan_tpu_torch``'s served path (``BENCHMARK.json``
at the root of the checkout names its cells; ``python3 -m gbench.run``
runs one). It imports neither JAX nor the JAX package ``titan_tpu``."""
