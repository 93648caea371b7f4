"""FleetRouter: the front-door job plane over N replica processes.

The fleet tier (reference: the titan-dist deployment — a
load balancer in front of N gremlin-server processes over shared
storage): one router process owns the public ``/jobs`` / ``/traverse``
/ ``/metrics?federate=1`` / ``/fleet`` surface and dispatches to
replica ``GraphServer`` processes, each a full ``JobScheduler`` over
the same store. docs/fleet.md documents the topology; the pieces:

* **membership** (:class:`~titan_tpu_torch.olap.fleet.membership.
  FleetMembership`) — Federator-backed health checks with
  consecutive-failure eviction + un-evict on recovery, plus the
  routing signals scraped from each replica's own exposition;
* **routing** — quota/SLO-aware weighted pick: per-replica in-flight
  depth (router ledger + scraped ``serving.queue.depth``), HBM
  headroom (``serving.hbm.resident_bytes``), epoch freshness lag, each
  normalized across the live set and weighted by the autotune fleet
  knob (``fleet.routing_weight.*``, journaled through the existing
  Controller rules — ``GET /controller`` explains every weight move);
* **failover** — every admitted job carries an **idempotency key**
  (the router's logical job id). A dead replica's in-flight jobs are
  re-dispatched to a survivor under the SAME key, so the survivor's
  scheduler adopts the newest checkpoint from the shared store
  (olap/recovery) and RESUMES rather than restarts — bit-equal to an
  uninterrupted run. ``serving.jobs.submitted`` is counted ONCE at
  router admission; a re-dispatch counts ``serving.fleet.redispatches``
  instead (the double-count regression, tests/test_fleet.py);
* **trace splice** — the router opens one trace per logical job
  (``GET /trace?job=<id>``) with a ``dispatch`` span per attempt; each
  pump round progressively drains every in-flight replica's
  ``GET /trace/export`` and splices the spans under the attempt's
  dispatch span with NTP-style skew normalization (``Tracer.ingest``,
  the scan_worker idiom) — after a SIGKILL the stitched tree shows the
  dead replica's partial spans BESIDE the redispatch span.

Metrics: ``serving.fleet.*`` (docs/monitoring.md) on the router's own
registry; ``?federate=1`` merges every replica's registry under
``instance`` labels for one fleet-wide scrape target.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import uuid
from typing import Optional, Sequence
from urllib.parse import parse_qs

from titan_tpu_torch.errors import TemporaryBackendError
from titan_tpu_torch.obs.tracing import Tracer
from titan_tpu_torch.olap.fleet.membership import FleetMembership
from titan_tpu_torch.utils.httpnode import (JsonNode, TextResponse, json_call,
                                      text_get)
from titan_tpu_torch.utils.metrics import MetricManager

#: routing signal names; each has an implicit weight of 1.0 unless the
#: controller's fleet knob (fleet.routing_weight.<signal>) moved it
ROUTE_SIGNALS = ("depth", "hbm", "lag")

_TERMINAL = ("done", "failed", "timeout", "cancelled", "expired")


class _FleetJob:
    """Router-side record of one LOGICAL job. ``id`` doubles as the
    idempotency key and the router-side trace id; ``remote_id`` is the
    replica scheduler's own job id for the current attempt."""

    __slots__ = ("id", "body", "kind", "tenant", "instance", "url",
                 "remote_id", "attempts", "state", "wire", "t_submit",
                 "t_dead", "root", "dispatch")

    def __init__(self, jid: str, body: dict, now: float):
        self.id = jid
        self.body = dict(body)
        self.kind = str(body.get("kind", "bfs"))
        self.tenant = str(body.get("tenant") or "default")
        self.instance: Optional[str] = None
        self.url: Optional[str] = None
        self.remote_id: Optional[str] = None
        self.attempts = 0
        self.state = "queued"
        self.wire: dict = {}
        self.t_submit = now
        self.t_dead: Optional[float] = None
        self.root = None
        self.dispatch = None

    def to_wire(self) -> dict:
        out = {"job": self.id, "kind": self.kind, "tenant": self.tenant,
               "state": self.state, "replica": self.instance,
               "remote_job": self.remote_id, "attempts": self.attempts}
        if self.wire:
            out["remote"] = self.wire
        return out


class FleetRouter(JsonNode):
    """See module doc. ``replicas``: ["host:port" | url, ...]; more can
    join later via :meth:`add_replica`. ``autotune`` follows the
    scheduler's modes ("off" | "shadow" | "enforce") for the fleet
    routing-weight knob; ``autopump=False`` (tests, bench) disables the
    background maintenance thread — call :meth:`pump` directly."""

    def __init__(self, replicas: Sequence[str] = (), *,
                 host: str = "127.0.0.1", port: int = 0,
                 metrics: Optional[MetricManager] = None,
                 tracer: Optional[Tracer] = None, clock=None,
                 fetch=None, token: Optional[str] = None,
                 auth_token: Optional[str] = None,
                 autotune: Optional[str] = "shadow",
                 autotune_tick_s: Optional[float] = None,
                 max_failures: int = 3, call_timeout_s: float = 30.0,
                 pump_interval_s: float = 0.25, autopump: bool = True):
        super().__init__(self._route, host, port, name="fleet-router",
                         auth_token=auth_token)
        self._metrics = metrics or MetricManager.instance()
        self.tracer = tracer or Tracer(clock=clock)
        self._clock = clock or time.time
        self._token = token
        self.call_timeout_s = float(call_timeout_s)
        self.membership = FleetMembership(
            metrics=self._metrics, clock=clock, fetch=fetch,
            timeout=call_timeout_s, max_failures=max_failures,
            token=token)
        self._ids = itertools.count(1)
        self._jobs: dict[str, _FleetJob] = {}
        self._inflight: dict[str, int] = {}
        self._lock = threading.RLock()
        self._pump_interval_s = float(pump_interval_s)
        self._pump_stop = threading.Event()
        self._pump_thread: Optional[threading.Thread] = None
        self._autopump = bool(autopump)
        # no-network read: the Federator's stored peer state, NOT a
        # fresh signal round — gauges run on every scrape
        self._up_fn = lambda: float(self.membership.fleet()["up"])
        self._up_gauge = self._metrics.gauge(
            "serving.fleet.replicas_up", fn=self._up_fn)
        from titan_tpu_torch.olap.serving.autotune import (Controller,
                                                     resolve_mode)
        mode = resolve_mode(autotune)
        self.controller = None
        if mode != "off":
            self.controller = Controller(
                mode=mode, metrics=self._metrics, tracer=self.tracer,
                clock=clock, tick_s=autotune_tick_s,
                signals=self._fleet_signals)
        for r in replicas:
            self.add_replica(r)

    # -- membership ----------------------------------------------------------

    def add_replica(self, url: str,
                    instance: Optional[str] = None) -> str:
        return self.membership.add_replica(url, instance=instance)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetRouter":
        super().start()
        self.membership.scrape()       # first routing round up front
        if self._autopump:
            self._pump_thread = threading.Thread(
                target=self._pump_loop, daemon=True,
                name="fleet-router-pump")
            self._pump_thread.start()
        return self

    def stop(self) -> None:
        self._pump_stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5.0)
            self._pump_thread = None
        if self.controller is not None:
            self.controller.detach_gauges()
        # identity-checked detach (the controller's idiom): a stopped
        # router must not keep reading dead membership on every scrape
        if self._up_gauge.fn is self._up_fn:
            self._up_gauge.fn = None
        super().stop()

    def _pump_loop(self) -> None:
        while not self._pump_stop.wait(self._pump_interval_s):
            try:
                self.pump()
            except Exception:   # noqa: BLE001 — the pump must survive
                pass

    # -- HTTP dispatch -------------------------------------------------------

    def _route(self, path: str, req: dict):
        route, _, query = path.partition("?")
        q = parse_qs(query)
        if route == "/jobs":
            # POST with a body submits; a GET (empty request dict)
            # lists the router's logical job table
            if req:
                return self._submit(req)
            with self._lock:
                jobs = [rec.to_wire() for rec in self._jobs.values()]
            return {"jobs": jobs, "inflight": dict(self._inflight)}
        if route.startswith("/jobs/"):
            return self._job_status(route[len("/jobs/"):])
        if route == "/traverse":
            return self._traverse(req)
        if route == "/metrics":
            from titan_tpu_torch.obs.promexport import (CONTENT_TYPE,
                                                  render_prometheus)
            body = render_prometheus(self._metrics)
            if (q.get("federate") or ["0"])[0] not in ("0", "",
                                                       "false"):
                # scrape-then-render: one coherent round, fleet-wide
                self.membership.scrape()
                body = self.membership.federator.render(body)
            return TextResponse(body, CONTENT_TYPE)
        if route == "/fleet":
            return self._fleet_view()
        if route == "/trace":
            tid = (q.get("job") or [None])[0]
            if tid is None:
                raise ValueError("trace needs ?job=<id>")
            tree = self.tracer.tree(tid)
            if tree is None:
                raise ValueError(f"unknown trace {tid!r}")
            return tree
        if route == "/controller":
            if self.controller is None:
                return {"enabled": False}
            return {"enabled": True, **self.controller.state()}
        if route == "/healthz":
            up = int(self.membership.fleet()["up"])
            return {"live": True, "ready": up > 0,
                    "role": "fleet-router", "replicas_up": up}
        if route == "/pump":
            return self.pump()
        raise ValueError(f"unknown path {path!r}")

    # -- admission + routing -------------------------------------------------

    def _submit(self, body: dict) -> dict:
        """Admit one logical job: route, dispatch, count. The submitted
        counter increments HERE exactly once per logical job — the
        replica's own registry also counts its local submit, but under
        ``?federate=1`` those re-export under ``instance`` labels and
        never fold into the router's series."""
        now = self._clock()
        jid = f"f{next(self._ids):04d}-{uuid.uuid4().hex[:6]}"
        rec = _FleetJob(jid, body, now)
        rec.root = self.tracer.start(jid, "job", kind=rec.kind,
                                     tenant=rec.tenant)
        if not self._dispatch_job(rec):
            self.tracer.end(rec.root, error="no replica accepted")
            self.tracer.discard(jid)
            raise TemporaryBackendError(
                "no replica accepted the job (fleet down?)")
        self._metrics.counter(
            "serving.jobs.submitted",
            labels={"kind": rec.kind, "tenant": rec.tenant}).inc()
        with self._lock:
            self._jobs[jid] = rec
        return rec.to_wire()

    def _dispatch_job(self, rec: _FleetJob,
                      exclude: Optional[set] = None) -> bool:
        """One dispatch walk over the live set (weighted-pick order):
        POST the job body + the logical idempotency key to a replica,
        falling through to the next pick when one refuses. Returns
        False when no replica accepted."""
        tried = set(exclude or ())
        while True:
            pick = self._pick(exclude=tried)
            if pick is None:
                return False
            inst, url = pick
            tried.add(inst)
            span = self.tracer.start(rec.id, "dispatch",
                                     parent=rec.root, instance=inst,
                                     attempt=rec.attempts + 1)
            payload = dict(rec.body)
            payload["idempotency_key"] = rec.id
            try:
                wire = json_call(url, "/jobs", payload,
                                 timeout=self.call_timeout_s,
                                 token=self._token)
            except Exception as e:   # noqa: BLE001 — replica boundary
                self.tracer.end(span,
                                error=f"{type(e).__name__}: {e}")
                continue
            rec.instance, rec.url = inst, url
            rec.remote_id = wire.get("job")
            rec.attempts += 1
            rec.state = wire.get("status", "queued")
            rec.wire = wire
            rec.dispatch = span
            with self._lock:
                self._inflight[inst] = self._inflight.get(inst, 0) + 1
            self._metrics.counter("serving.fleet.routed",
                                  labels={"instance": inst}).inc()
            return True

    def _weights(self) -> dict:
        w = {s: 1.0 for s in ROUTE_SIGNALS}
        if self.controller is not None:
            w.update(self.controller.routing_weights())
        return w

    def _pick(self, exclude=()) -> Optional[tuple]:
        """The weighted pick: min weighted sum of normalized signals
        over the live set (lower = roomier), deterministic tie-break by
        instance name."""
        sig = self.membership.signals()
        with self._lock:
            rows = []
            for inst, s in sig.items():
                if not s["up"] or inst in exclude:
                    continue
                depth = (self._inflight.get(inst, 0)
                         + float(s["queue_depth"]))
                rows.append((inst, s["url"], depth,
                             float(s["hbm_resident_bytes"]),
                             float(s["lag_epochs"])))
        if not rows:
            return None
        w = self._weights()
        maxes = [max(1.0, max(r[i] for r in rows)) for i in (2, 3, 4)]
        best = None
        for inst, url, depth, hbm, lag in sorted(rows):
            score = (w["depth"] * depth / maxes[0]
                     + w["hbm"] * hbm / maxes[1]
                     + w["lag"] * lag / maxes[2])
            if best is None or score < best[0]:
                best = (score, inst, url)
        return best[1], best[2]

    # -- interactive proxy ---------------------------------------------------

    def _traverse(self, body: dict) -> dict:
        """Route one interactive point query. Traversals are read-only
        and carry no idempotency state, so a refused/failed replica
        simply falls through to the next pick."""
        tried: set = set()
        last: Optional[BaseException] = None
        while True:
            pick = self._pick(exclude=tried)
            if pick is None:
                if last is not None:
                    raise last
                raise TemporaryBackendError("no replica up")
            inst, url = pick
            tried.add(inst)
            try:
                out = json_call(url, "/traverse", dict(body),
                                timeout=self.call_timeout_s,
                                token=self._token)
            except TemporaryBackendError as e:
                last = e
                continue
            self._metrics.counter("serving.fleet.routed",
                                  labels={"instance": inst}).inc()
            out["replica"] = inst
            return out

    # -- status + pump -------------------------------------------------------

    def _get_json(self, url: str, path: str) -> dict:
        return json.loads(text_get(url, path,
                                   timeout=self.call_timeout_s,
                                   token=self._token))

    def _job_status(self, jid: str) -> dict:
        with self._lock:
            rec = self._jobs.get(jid)
        if rec is None:
            raise ValueError(f"unknown job {jid!r}")
        if rec.state not in _TERMINAL and rec.url is not None:
            try:
                rec.wire = self._get_json(rec.url,
                                          f"/jobs/{rec.remote_id}")
                rec.state = rec.wire.get("status", rec.state)
            except Exception:   # noqa: BLE001 — pump owns failover
                pass
        return rec.to_wire()

    def _fleet_view(self) -> dict:
        fl = self.membership.fleet()
        with self._lock:
            inflight = dict(self._inflight)
            total = len(self._jobs)
        return {"enabled": True, **fl,
                "routing": {
                    "weights": self._weights(),
                    "inflight": inflight,
                    "decisions": int(self._metrics.counter_value(
                        "serving.fleet.routed"))},
                "jobs": {"total": total,
                         "redispatches": int(
                             self._metrics.counter_value(
                                 "serving.fleet.redispatches"))}}

    def _fleet_signals(self) -> dict:
        """The router controller's signal source: only the ``fleet``
        block (no scheduler registries behind this controller), so of
        the rule table exactly ``_rule_fleet`` can ever fire."""
        sig: dict = {"t": self._clock()}
        depths: dict = {}
        up: list = []
        for inst, s in self.membership.signals().items():
            with self._lock:
                d = self._inflight.get(inst, 0)
            depths[inst] = d
            if s["up"]:
                up.append(d)
        fleet: dict = {"depths": depths, "replicas_up": len(up)}
        if len(up) >= 2:
            mean = sum(up) / len(up)
            fleet["depth_spread"] = (
                round((max(up) - min(up)) / mean, 4) if mean > 0
                else 0.0)
        sig["fleet"] = fleet
        return sig

    def pump(self) -> dict:
        """One maintenance round: scrape membership (evict/un-evict),
        tick the fleet controller, poll every in-flight job, drain its
        replica-side spans into the stitched trace, and fail over jobs
        whose replica is down. Runs on the background pump thread (or
        directly from tests/bench via ``POST /pump``)."""
        out = {"polled": 0, "completed": 0, "redispatched": 0,
               "orphaned": 0}
        self.membership.scrape()
        if self.controller is not None:
            try:
                self.controller.maybe_tick()
            except Exception:   # noqa: BLE001 — advisory plane
                pass
        rows = {r["instance"]: r
                for r in self.membership.fleet()["peers"]}
        with self._lock:
            live = [rec for rec in self._jobs.values()
                    if rec.state not in _TERMINAL]
        for rec in live:
            if rec.dispatch is None:
                # orphaned on an earlier round (no survivor then) —
                # keep trying until a replica comes back
                if self._failover(rec, why="orphaned: no survivor"):
                    out["redispatched"] += 1
                else:
                    out["orphaned"] += 1
                continue
            try:
                wire = self._get_json(rec.url,
                                      f"/jobs/{rec.remote_id}")
            except Exception as e:   # noqa: BLE001 — replica boundary
                row = rows.get(rec.instance)
                if row is None or not row.get("up"):
                    # the health plane agrees the replica is down —
                    # this is a death, not a blip
                    if self._failover(
                            rec, why=f"{type(e).__name__}: {e}"):
                        out["redispatched"] += 1
                    else:
                        out["orphaned"] += 1
                continue
            out["polled"] += 1
            self._drain_trace(rec)
            rec.wire = wire
            rec.state = wire.get("status", rec.state)
            if rec.state in _TERMINAL:
                out["completed"] += 1
                with self._lock:
                    self._inflight[rec.instance] = max(
                        0, self._inflight.get(rec.instance, 0) - 1)
                self.tracer.end(rec.dispatch, state=rec.state)
                self.tracer.end(rec.root, state=rec.state)
        return out

    def _failover(self, rec: _FleetJob, why: str) -> bool:
        """Re-dispatch one in-flight job off a dead replica under its
        UNCHANGED idempotency key: the survivor's scheduler finds the
        dead replica's checkpoints in the shared store (keyed
        ``idem-<key>``) and resumes. Counts
        ``serving.fleet.redispatches`` — NEVER a second
        ``serving.jobs.submitted``."""
        dead = rec.instance
        if rec.dispatch is not None:
            self.tracer.end(rec.dispatch, error=why,
                            redispatched=True)
            rec.dispatch = None
            rec.t_dead = self._clock()
            with self._lock:
                self._inflight[dead] = max(
                    0, self._inflight.get(dead, 0) - 1)
        if not self._dispatch_job(rec, exclude={dead}):
            return False
        self._metrics.counter("serving.fleet.redispatches").inc()
        if rec.t_dead is not None:
            self._metrics.histogram(
                "serving.fleet.redispatch_latency_ms").update(
                (self._clock() - rec.t_dead) * 1e3)
        return True

    def _drain_trace(self, rec: _FleetJob) -> None:
        """Progressively pop the replica's completed spans for this
        attempt and splice them under the dispatch span (scan_worker's
        NTP-midpoint skew + clamp-window idiom). Progressive draining
        is what makes a dead replica's PARTIAL spans visible: whatever
        rode earlier pump rounds is already in the stitched tree when
        the replica dies."""
        if not self.tracer.enabled or rec.dispatch is None:
            return
        t0 = self._clock()
        try:
            res = self._get_json(
                rec.url, f"/trace/export?job={rec.remote_id}")
        except Exception:   # noqa: BLE001 — next round retries
            return
        t1 = self._clock()
        spans = res.get("spans") or []
        dropped = int(res.get("dropped") or 0)
        if not spans and not dropped:
            return
        try:
            offset = ((t0 + t1) - (float(res["t_recv"])
                                   + float(res["t_send"]))) / 2.0
        except (KeyError, TypeError, ValueError):
            offset = 0.0
        self.tracer.ingest(
            rec.id, spans, parent_id=rec.dispatch.span_id,
            offset=offset, window=(t0, t1), instance=rec.instance,
            extra_dropped=dropped, metrics=self._metrics)
