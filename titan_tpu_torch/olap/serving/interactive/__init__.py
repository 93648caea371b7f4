"""Interactive traversal lane: OLTP-shaped point reads on the OLAP plane
(port of ``titan_tpu/olap/serving/interactive``).

Bounded-depth dsl chains compile onto the batched ``[K, n]`` frontier
machinery (``compile.py`` -> ``models/bfs_hybrid.frontier_bfs_batched``
``mode="hops"``, through the ``frontier_round`` and ``batched_exhaust``
kernels on the card), a deadline-driven micro-batcher fuses concurrent
point queries into one device run (``collector.py``), and a low-latency
lane bypasses the heavy OLAP queue while flowing through tenant quotas,
tracing and the device-cost profiler (``scheduler.py``). Batched
personalized PageRank rides the same lane. Entry point:
``JobScheduler.interactive()``; metrics ``serving.interactive.*``;
unsupported chains fall back loudly to the dsl interpreter
(``FallbackToInterpreter``).
"""

from titan_tpu_torch.olap.serving.interactive.collector import (
    Collector, InteractiveRequest)
from titan_tpu_torch.olap.serving.interactive.compile import (
    DEFAULT_MAX_DEPTH, Direction, FallbackToInterpreter, PPRPlan,
    TraversalPlan, compile_steps, compile_traversal, plan_from_wire,
    traversal_from_plan)
from titan_tpu_torch.olap.serving.interactive.scheduler import (
    InteractiveLane)

__all__ = ["Collector", "InteractiveRequest", "DEFAULT_MAX_DEPTH",
           "Direction", "FallbackToInterpreter", "PPRPlan",
           "TraversalPlan", "compile_steps", "compile_traversal",
           "plan_from_wire", "traversal_from_plan", "InteractiveLane"]
