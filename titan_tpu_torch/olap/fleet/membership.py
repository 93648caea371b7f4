"""Fleet membership: health-checked replicas + routing signals.

The membership plane is the Federator (obs/federate) pointed at replica
``GraphServer`` processes instead of scan workers: each replica already
serves ``GET /metrics`` (Prometheus text) and ``GET /healthz``, so
health checking, consecutive-failure eviction and un-evict on recovery
come for free — this module adds the ROUTING read on top. From each
scrape round it extracts the per-replica signals the router's weighted
pick consumes (docs/fleet.md "Routing policy"):

* **in-flight depth** — ``serving_queue_depth`` from the replica's own
  exposition (the router adds its own live dispatch ledger on top,
  because scraped depth is one round stale);
* **HBM headroom** — ``serving_hbm_resident_bytes`` (a loaded replica
  with resident graph images is cheaper to route TO for the same
  snapshot, but an HBM-saturated one should shed);
* **epoch freshness lag** — the replica's ``GET /live`` freshness block
  (``lag_epochs``), best-effort: a replica without a live plane reads
  as lag 0.

Signal extraction parses the SAME scraped exposition text the federated
``/metrics`` view re-exports (``obs.federate._parse_families``), so
routing and observability can never disagree about what a replica
reported.
"""

from __future__ import annotations

import json
from typing import Optional

from titan_tpu_torch.obs.federate import Federator, _parse_families
from titan_tpu_torch.utils.httpnode import text_get
from titan_tpu_torch.utils.metrics import MetricManager

#: exposition sample names the router reads (sanitized Prometheus
#: names — promexport maps metric-name dots to underscores)
_DEPTH_SAMPLE = "serving_queue_depth"
_HBM_SAMPLE = "serving_hbm_resident_bytes"


def _unlabeled_value(fams: dict, name: str) -> Optional[float]:
    """The unlabeled parent sample of ``name`` from a parsed
    exposition, or None when the replica never registered it."""
    fam = fams.get(name)
    if not fam:
        return None
    for line in fam["samples"]:
        head, _, rest = line.partition(" ")
        if head == name:        # the unlabeled parent, not a child
            try:
                return float(rest.split()[0])
            except (ValueError, IndexError):
                return None
    return None


class FleetMembership:
    """Replica set + routing-signal reads for the FleetRouter.

    ``fetch(url, path) -> text`` is injectable (tests); the default is
    ``utils.httpnode.text_get`` carrying the mesh bearer token, exactly
    like the Federator's."""

    def __init__(self, metrics: Optional[MetricManager] = None,
                 clock=None, fetch=None, *, timeout: float = 5.0,
                 max_failures: int = 3, token: Optional[str] = None):
        self._metrics = metrics or MetricManager.instance()
        self._fetch = fetch or (lambda url, path: text_get(
            url, path, timeout=timeout, token=token))
        self.federator = Federator(
            metrics=self._metrics, clock=clock, fetch=self._fetch,
            timeout=timeout, max_failures=max_failures, token=token)
        # per-scrape-round lag memo: the routing pick runs per submit,
        # and freshness moves per scrape, not per job — one /live fetch
        # per replica per round, not per routing decision
        self._lag_cache: dict = {}

    # -- membership ----------------------------------------------------------

    def add_replica(self, url: str,
                    instance: Optional[str] = None) -> str:
        return self.federator.add_peer(url, instance=instance)

    def remove_replica(self, instance: str) -> bool:
        return self.federator.remove_peer(instance)

    def scrape(self) -> dict:
        """One health/metrics round over every replica (failure
        counting + eviction + un-evict live in the Federator)."""
        self._lag_cache.clear()
        return self.federator.scrape()

    def fleet(self) -> dict:
        """The ``GET /fleet`` roll-up (per-replica up/evicted/failure
        state), straight from the Federator."""
        return self.federator.fleet()

    # -- routing signals -----------------------------------------------------

    def signals(self) -> dict:
        """``{instance: {"up", "url", "queue_depth",
        "hbm_resident_bytes", "lag_epochs"}}`` from the LAST scrape
        round — call :meth:`scrape` first. Signal reads are
        best-effort: a replica that answered its scrape but exposes
        none of the serving families routes on depth 0 (new replicas
        must be routable before their first job)."""
        out: dict = {}
        for peer in self.federator.peers():
            up = (not peer.evicted and peer.failures == 0
                  and peer.last_ok is not None)
            row = {"up": up, "url": peer.url, "queue_depth": 0.0,
                   "hbm_resident_bytes": 0.0, "lag_epochs": 0.0}
            if peer.text:
                fams = _parse_families(peer.text)
                d = _unlabeled_value(fams, _DEPTH_SAMPLE)
                if d is not None:
                    row["queue_depth"] = max(0.0, d)
                h = _unlabeled_value(fams, _HBM_SAMPLE)
                if h is not None:
                    row["hbm_resident_bytes"] = max(0.0, h)
            if up:
                lag = self._lag_cache.get(peer.instance)
                if lag is None:
                    lag = self._lag_epochs(peer.url)
                    self._lag_cache[peer.instance] = lag
                row["lag_epochs"] = lag
            out[peer.instance] = row
        return out

    def _lag_epochs(self, url: str) -> float:
        """Epoch freshness lag from the replica's ``GET /live``; 0 for
        replicas without a live plane (or mid-death — the health plane
        owns liveness, this read must never evict anyone)."""
        try:
            live = json.loads(self._fetch(url, "/live"))
        except Exception:   # noqa: BLE001 — best-effort signal
            return 0.0
        if not isinstance(live, dict) or not live.get("enabled"):
            return 0.0
        fresh = live.get("freshness") or {}
        try:
            return max(0.0, float(fresh.get("lag_epochs", 0)))
        except (TypeError, ValueError):
            return 0.0
