"""Metrics federation + fleet health across worker processes.

Each scan worker (and every fleet replica) already renders
its own registry as Prometheus text on ``GET /metrics`` and answers
``GET /healthz``; this module is the coordinator half: a ``Federator``
holds a set of registered peers, scrapes them, and re-exports their
families merged with the local exposition under an ``instance`` label —
one scrape target for the whole fleet, surfaced by the HTTP server as
``GET /metrics?federate=1`` and summarized by ``GET /fleet``.

Design constraints, mirroring the rest of the observability plane:

* **bounded** — at most ``max_series_per_peer`` samples re-exported per
  peer (overflow counted in ``obs.federate.series_dropped``), so one
  misbehaving worker with exploding label cardinality cannot balloon
  the coordinator's scrape body;
* **self-healing** — ``max_failures`` consecutive scrape failures evict
  a peer from the federated output (``obs.federate.evicted``); the peer
  record survives eviction so ``GET /fleet`` reports the death instead
  of forgetting the worker existed. A later successful scrape
  un-evicts it (workers restart);
* **deterministic tests** — the clock and the fetch callable are both
  injectable (the default fetch is ``utils.httpnode.text_get``, which
  carries the mesh bearer token);
* **grammar-preserving** — the merged body keeps ``# HELP`` / ``# TYPE``
  lines once per family across instances (first writer wins — the
  local exposition, then peers in registration order) and emits every
  family as one contiguous block, so any 0.0.4 parser reads it like a
  single-process scrape.

Self-metrics: ``obs.federate.scrapes`` / ``obs.federate.errors``
(by ``{instance}``) / ``obs.federate.evicted`` /
``obs.federate.series_dropped`` — documented in docs/monitoring.md.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from typing import Optional

from titan_tpu_torch.obs.promexport import _esc
from titan_tpu_torch.utils.httpnode import text_get
from titan_tpu_torch.utils.metrics import MetricManager

#: consecutive scrape failures before a peer leaves the federated body
DEFAULT_MAX_FAILURES = 3
#: re-exported samples per peer per scrape (overflow counted + dropped)
DEFAULT_MAX_SERIES = 2000


class _Peer:
    __slots__ = ("instance", "url", "added_at", "last_ok", "last_error",
                 "failures", "evicted", "text", "health")

    def __init__(self, instance: str, url: str, now: float):
        self.instance = instance
        self.url = url
        self.added_at = now
        self.last_ok: Optional[float] = None
        self.last_error: Optional[str] = None
        self.failures = 0
        self.evicted = False
        self.text: Optional[str] = None
        self.health: Optional[dict] = None


def _parse_families(text: str) -> "OrderedDict[str, dict]":
    """Exposition text → ordered ``{family: {"help", "type",
    "samples"}}``. Samples whose name extends the current family's
    (``_count`` / ``_sum`` / quantile'd) stay grouped with it, so a
    summary survives the round trip as one block."""
    fams: "OrderedDict[str, dict]" = OrderedDict()
    cur = None
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                continue
            name = parts[2]
            fam = fams.setdefault(
                name, {"help": None, "type": None, "samples": []})
            if parts[1] == "HELP" and fam["help"] is None:
                fam["help"] = line
            elif parts[1] == "TYPE" and fam["type"] is None:
                fam["type"] = line
            cur = name
        elif line.startswith("#"):
            continue
        else:
            name = line.split("{", 1)[0].split(" ", 1)[0]
            key = cur if cur is not None and name.startswith(cur) \
                else name
            fams.setdefault(
                key, {"help": None, "type": None, "samples": []}
            )["samples"].append(line)
    return fams


def _inject_instance(sample: str, instance: str) -> str:
    """One sample line with ``instance="..."`` prepended to its label
    set (escaped per the exposition spec)."""
    pair = f'instance="{_esc(instance)}"'
    brace = sample.find("{")
    if brace >= 0:
        close = sample.rfind("}")
        if close > brace:
            inner = sample[brace + 1:close]
            sep = "," if inner else ""
            return (sample[:brace] + "{" + pair + sep + inner
                    + sample[close:])
    name, _, rest = sample.partition(" ")
    return f"{name}{{{pair}}} {rest}"


class Federator:
    """Registered peers → one merged Prometheus exposition + one fleet
    health roll-up. Thread-safe; scrapes happen on the caller's thread
    (the HTTP handler serving ``?federate=1`` / ``/fleet``)."""

    def __init__(self, metrics: Optional[MetricManager] = None,
                 clock=None, fetch=None, *, timeout: float = 5.0,
                 max_failures: int = DEFAULT_MAX_FAILURES,
                 max_series_per_peer: int = DEFAULT_MAX_SERIES,
                 token: Optional[str] = None):
        self._metrics = metrics or MetricManager.instance()
        self.clock = clock or time.time
        self.timeout = float(timeout)
        self.max_failures = int(max_failures)
        self.max_series_per_peer = int(max_series_per_peer)
        self._token = token
        self._fetch = fetch or (lambda url, path: text_get(
            url, path, timeout=self.timeout, token=self._token))
        self._peers: "OrderedDict[str, _Peer]" = OrderedDict()
        self._lock = threading.Lock()

    # -- membership ----------------------------------------------------------

    def add_peer(self, url: str, instance: Optional[str] = None) -> str:
        """Register a peer; ``instance`` defaults to ``host:port``
        (the label value on every re-exported sample). Re-adding an
        instance replaces its record (a restarted worker starts
        clean). Returns the instance name."""
        url = url if "://" in url else f"http://{url}"
        if instance is None:
            instance = url.split("://", 1)[1].rstrip("/")
        with self._lock:
            self._peers[instance] = _Peer(instance, url, self.clock())
        return instance

    def remove_peer(self, instance: str) -> bool:
        with self._lock:
            return self._peers.pop(instance, None) is not None

    def peers(self) -> list:
        with self._lock:
            return list(self._peers.values())

    # -- scrape --------------------------------------------------------------

    def scrape(self) -> dict:
        """Fetch every peer's ``/metrics`` (and ``/healthz``) once;
        returns ``{instance: ok}``. Failure counting + eviction happen
        here — callers scrape right before rendering, so the federated
        body and the fleet view reflect the same round."""
        out = {}
        for peer in self.peers():
            self._metrics.counter("obs.federate.scrapes").inc()
            try:
                text = self._fetch(peer.url, "/metrics")
            except Exception as e:   # noqa: BLE001 — peer boundary
                self._metrics.counter(
                    "obs.federate.errors",
                    labels={"instance": peer.instance}).inc()
                with self._lock:
                    peer.failures += 1
                    peer.last_error = f"{type(e).__name__}: {e}"
                    if peer.failures >= self.max_failures and \
                            not peer.evicted:
                        peer.evicted = True
                        peer.text = None
                        self._metrics.counter(
                            "obs.federate.evicted").inc()
                out[peer.instance] = False
                continue
            health = None
            try:
                health = json.loads(self._fetch(peer.url, "/healthz"))
            except Exception:   # noqa: BLE001 — health is best-effort
                pass
            with self._lock:
                peer.failures = 0
                peer.evicted = False
                peer.last_ok = self.clock()
                peer.last_error = None
                peer.text = text
                if health is not None:
                    peer.health = health
            out[peer.instance] = True
        return out

    # -- render --------------------------------------------------------------

    def render(self, local_text: str = "") -> str:
        """The federated exposition: the local body verbatim, then each
        live peer's families with ``instance`` injected into every
        sample — merged family-by-family so HELP/TYPE appear once and
        samples stay contiguous per family."""
        merged = _parse_families(local_text or "")
        dropped = 0
        for peer in self.peers():
            if peer.evicted or not peer.text:
                continue
            budget = self.max_series_per_peer
            for name, fam in _parse_families(peer.text).items():
                tgt = merged.setdefault(
                    name, {"help": None, "type": None, "samples": []})
                if tgt["help"] is None:
                    tgt["help"] = fam["help"]
                if tgt["type"] is None:
                    tgt["type"] = fam["type"]
                for s in fam["samples"]:
                    if budget <= 0:
                        dropped += 1
                        continue
                    tgt["samples"].append(
                        _inject_instance(s, peer.instance))
                    budget -= 1
        if dropped:
            self._metrics.counter(
                "obs.federate.series_dropped").inc(dropped)
        lines: list = []
        for fam in merged.values():
            if fam["help"]:
                lines.append(fam["help"])
            if fam["type"]:
                lines.append(fam["type"])
            lines.extend(fam["samples"])
        return "\n".join(lines) + "\n" if lines else "\n"

    # -- fleet ---------------------------------------------------------------

    def fleet(self) -> dict:
        """The ``GET /fleet`` roll-up: per-peer liveness derived from
        the last scrape round (plus the peer's own ``/healthz`` body
        when it answered one)."""
        now = self.clock()
        rows = []
        up = 0
        for peer in self.peers():
            with self._lock:
                ok = (not peer.evicted and peer.failures == 0
                      and peer.last_ok is not None)
                row = {"instance": peer.instance, "url": peer.url,
                       "up": ok, "evicted": peer.evicted,
                       "consecutive_failures": peer.failures,
                       "last_ok_age_s":
                           round(now - peer.last_ok, 3)
                           if peer.last_ok is not None else None,
                       "last_error": peer.last_error}
                if peer.health is not None:
                    row["health"] = peer.health
            rows.append(row)
            up += 1 if ok else 0
        return {"peers": rows, "up": up, "down": len(rows) - up}
