"""Replica fleet serving tier (docs/fleet.md).

One :class:`~titan_tpu_torch.olap.fleet.router.FleetRouter` process owns the
public job plane and dispatches to N replica processes (each a full
GraphServer + JobScheduler over the same store, ``python -m
titan_tpu_torch.olap.fleet.replica``). Membership is health-checked through
the Federator; routing is a quota/SLO-aware weighted pick over
in-flight depth, HBM headroom and epoch freshness; failover
re-dispatches a dead replica's jobs under an unchanged idempotency key
so the survivor resumes from the shared checkpoint store.
"""

from titan_tpu_torch.olap.fleet.membership import FleetMembership
from titan_tpu_torch.olap.fleet.router import ROUTE_SIGNALS, FleetRouter

__all__ = ["FleetMembership", "FleetRouter", "ROUTE_SIGNALS"]
