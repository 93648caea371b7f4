"""Per-tenant attribution + quota admission for the serving plane.

The dimension added under the job scheduler: every job belongs
to a tenant (``JobSpec.tenant``; absent/empty falls back to
``"default"`` everywhere — wire envelopes, traces, metrics — never a
KeyError), and the scheduler accounts the resources its execution
actually consumed to that tenant:

* **queue-ms** — submit → first start, sampled once per job;
* **device-seconds** — batch wall time split evenly across the K fused
  jobs (the shared level loop serves all K at once, so an even split is
  the amortization-aware attribution);
* **HBM byte-seconds** — the leased graph image's ledger bytes × batch
  wall time, split across the K jobs sharing the image;
* **replayed rounds** — recovery-plane work re-executed on the tenant's
  behalf after crashes.

``TenantAccounting`` is the authoritative store behind ``GET /tenants``
(the labeled metric children mirror the countable parts into the
Prometheus plane). ``TenantQuota`` holds per-tenant admission limits,
checked at ``submit()`` BEHIND A FLAG (``JobScheduler(
enforce_quotas=True)``, default off): with enforcement off a violating
submit is still admitted but counted ``serving.tenant.throttled``
(shadow mode — admission control lands observable-first); with it on
the submit raises ``QuotaExceeded`` (HTTP 429) and counts
``serving.tenant.rejected``.

The port's copy of ``titan_tpu/olap/serving/tenants.py``, host code only.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

#: the tenant every unattributed job belongs to
DEFAULT_TENANT = "default"


def effective_tenant(value) -> str:
    """``JobSpec.tenant`` → the accounting/label tenant: absent or
    empty falls back to ``DEFAULT_TENANT``; anything else is
    stringified (the wire may send numbers)."""
    if value is None or value == "":
        return DEFAULT_TENANT
    return str(value)


class QuotaExceeded(ValueError):
    """Submit refused by a tenant quota (only with enforcement on).
    A ValueError so in-process callers get the admission-error
    taxonomy; the HTTP layer maps it to 429 + ``retryable: true`` —
    the same request may succeed once the tenant's load drains."""


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission limits; ``None`` = unlimited.

    ``max_in_flight`` caps concurrently admitted (non-terminal) jobs;
    ``max_hbm_bytes`` refuses NEW submits while the tenant's running
    jobs hold more than this many ledger bytes (attributed per batch
    share); ``max_device_seconds`` is a cumulative budget — once the
    tenant has burned it, further submits are refused until the
    scheduler (and its accounting) is recreated."""

    max_in_flight: Optional[int] = None
    max_hbm_bytes: Optional[float] = None
    max_device_seconds: Optional[float] = None

    def to_wire(self) -> dict:
        return {"max_in_flight": self.max_in_flight,
                "max_hbm_bytes": self.max_hbm_bytes,
                "max_device_seconds": self.max_device_seconds}


def _row() -> dict:
    return {"in_flight": 0, "submitted": 0, "rejected": 0,
            "throttled": 0, "queue_ms": 0.0, "device_seconds": 0.0,
            "hbm_byte_seconds": 0.0, "hbm_running_bytes": 0.0,
            "rounds_replayed": 0, "by_state": {}}


class TenantAccounting:
    """Thread-safe per-tenant resource ledger (see module doc)."""

    def __init__(self):
        self._t: dict[str, dict] = {}
        self._lock = threading.Lock()

    def _get(self, tenant: str) -> dict:
        return self._t.setdefault(tenant, _row())

    # -- lifecycle ----------------------------------------------------------

    def admit(self, tenant: str, quota: Optional["TenantQuota"],
              enforce: bool) -> Optional[str]:
        """Atomic quota-check-and-admit: under ONE lock hold, evaluate
        the tenant's quota and either reserve the admission (submitted
        + in-flight move together) or — violating with ``enforce`` —
        count the rejection and reserve nothing. Returns the violation
        reason (None when within quota). The check and the reservation
        MUST be one critical section: concurrent submits racing a
        max_in_flight limit would otherwise both read "below limit"
        and both admit (the HTTP server runs handlers concurrently).
        In shadow mode (``enforce=False``) a violating submit is still
        admitted, counted throttled."""
        with self._lock:
            r = self._get(tenant)
            why = self._violation_locked(r, quota)
            if why is not None:
                if enforce:
                    r["rejected"] += 1
                    return why
                r["throttled"] += 1
            r["submitted"] += 1
            r["in_flight"] += 1
            return why

    def unadmit(self, tenant: str) -> None:
        """Back out an ``admit`` reservation for a job that was never
        actually accepted (closed-scheduler refusal lands AFTER the
        quota gate) — without polluting ``by_state``."""
        with self._lock:
            r = self._get(tenant)
            r["submitted"] = max(0, r["submitted"] - 1)
            r["in_flight"] = max(0, r["in_flight"] - 1)

    def finished(self, tenant: str, state: str,
                 rounds_replayed: int = 0) -> None:
        with self._lock:
            r = self._get(tenant)
            r["in_flight"] = max(0, r["in_flight"] - 1)
            r["by_state"][state] = r["by_state"].get(state, 0) + 1
            r["rounds_replayed"] += int(rounds_replayed)


    # -- resource attribution -----------------------------------------------

    def queue_ms(self, tenant: str, ms: float) -> None:
        with self._lock:
            self._get(tenant)["queue_ms"] += float(ms)

    def device_seconds(self, tenant: str, seconds: float) -> None:
        with self._lock:
            self._get(tenant)["device_seconds"] += float(seconds)

    def hbm_byte_seconds(self, tenant: str, byte_s: float) -> None:
        with self._lock:
            self._get(tenant)["hbm_byte_seconds"] += float(byte_s)

    def hold_hbm(self, tenant: str, nbytes: float) -> None:
        with self._lock:
            self._get(tenant)["hbm_running_bytes"] += float(nbytes)

    def drop_hbm(self, tenant: str, nbytes: float) -> None:
        with self._lock:
            r = self._get(tenant)
            r["hbm_running_bytes"] = max(
                0.0, r["hbm_running_bytes"] - float(nbytes))

    # -- reads --------------------------------------------------------------

    def violation(self, tenant: str,
                  quota: Optional[TenantQuota]) -> Optional[str]:
        """Human-readable reason the tenant's NEXT submit violates its
        quota, or None. Read-only probe (tests/diagnostics); the
        admission path uses ``admit`` so check and reservation share
        one critical section."""
        with self._lock:
            return self._violation_locked(
                self._t.get(tenant) or _row(), quota)

    @staticmethod
    def _violation_locked(r: dict,
                          quota: Optional[TenantQuota]) -> Optional[str]:
        if quota is None:
            return None
        if quota.max_in_flight is not None \
                and r["in_flight"] >= quota.max_in_flight:
            return (f"in-flight limit reached "
                    f"({r['in_flight']} >= {quota.max_in_flight})")
        if quota.max_hbm_bytes is not None \
                and r["hbm_running_bytes"] > quota.max_hbm_bytes:
            return (f"HBM limit exceeded "
                    f"({r['hbm_running_bytes']:.0f} > "
                    f"{quota.max_hbm_bytes:.0f} bytes held by running "
                    f"jobs)")
        if quota.max_device_seconds is not None \
                and r["device_seconds"] >= quota.max_device_seconds:
            return (f"device-seconds budget burned "
                    f"({r['device_seconds']:.3f}s >= "
                    f"{quota.max_device_seconds:.3f}s)")
        return None

    def stats(self) -> dict:
        """Deep-copied per-tenant rows (wire-safe)."""
        with self._lock:
            return {t: {**r, "by_state": dict(r["by_state"])}
                    for t, r in sorted(self._t.items())}
