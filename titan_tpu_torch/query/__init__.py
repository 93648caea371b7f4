"""Graph-centric and vertex-centric queries (the port's copy of
``titan_tpu/query/``)."""

from titan_tpu_torch.query.predicates import P

__all__ = ["P"]
