"""Graph factory — the ``titan_tpu_torch.open`` entry point.

(reference: titan-core core/TitanFactory.java:42,62-130 — accepts a backend
shorthand (``"inmemory"``, ``"sqlite:/path"``), a dotted-path dict, or a
typed Configuration, and opens a StandardGraph.)
"""

from __future__ import annotations

from typing import Union

from titan_tpu_torch.config import Configuration, MapConfiguration, defaults as d


def open_graph(config: Union[str, dict, Configuration]):
    from titan_tpu_torch.core.graph import StandardGraph

    if isinstance(config, str):
        if ":" in config:
            backend, _, directory = config.partition(":")
            raw = {"storage.backend": backend, "storage.directory": directory}
        else:
            raw = {"storage.backend": config}
        config = Configuration(d.ROOT, MapConfiguration(raw))
    elif isinstance(config, dict):
        config = Configuration(d.ROOT, MapConfiguration(dict(config)))
    elif not isinstance(config, Configuration):
        raise TypeError(f"cannot open graph from {type(config).__name__}")
    return StandardGraph(config)
