"""The Gremlin-style traversal DSL and its compiled path (the port's copy
of ``titan_tpu/traversal/``)."""

from titan_tpu_torch.traversal.dsl import GraphTraversalSource, Traversal

__all__ = ["GraphTraversalSource", "Traversal"]
