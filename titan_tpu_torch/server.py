"""HTTP graph server + console — the deployment surface (the port's copy
of ``titan_tpu/server.py``; jobs and point queries run on the CUDA card
through the port's scheduler and interactive lane).

(reference: titan-dist/src/assembly/static — Gremlin Server wired to a Titan
graph via gremlin-server.yaml (conf/gremlin-server/gremlin-server.yaml), the
``gremlin.sh`` console with the Titan plugin
(titan-all/.../TitanGremlinPlugin.java:18), and ``titan.sh`` start/stop.
The rebuild keeps the same shape — a long-running server process hosting an
open graph and evaluating traversal scripts submitted by clients, plus an
interactive console — on stdlib HTTP + JSON instead of Netty/Gremlin-wire.)

Endpoints:
  GET  /status      — instance id, backend, vertex-program computer, metrics
  GET  /schema      — declared schema types
  POST /traversal   — {"gremlin": "g.V().has('name','x').out().count()"}
                      evaluated against bindings {g, P, graph}; like Gremlin
                      Server's script engine, the endpoint executes caller
                      scripts — deploy it only where the caller is trusted.
  POST /traverse    — the interactive point-query lane
                      (olap/serving/interactive): bounded-depth
                      traversals compiled onto the batched [K, n]
                      frontier kernels — concurrent calls of
                      compatible shape FUSE into one device dispatch
                      inside a few-ms window. Body (structured):
                      {"start": [vertex ids], "dir": "out|in|both",
                       "hops": 2, "labels": [...],
                       "terminal": "id" | "count" | {"values": key},
                       "tenant": "team-a"}
                      or {"gremlin": "g.V(5).out().dedup().id_()"} —
                      a dsl chain, compiled when inside the supported
                      subset, LOUDLY interpreter-executed otherwise
                      (serving.interactive.fallbacks; response carries
                      "fallback": true). Personalized PageRank rides
                      the same lane: {"kind": "ppr", "source": id,
                      "iterations": 20, "damping": 0.85, "top_k": 10}
                      → per-user [vertex id, rank] recommendations out
                      of one batched [S, n] run. Responses
                      carry the fuse evidence (batch id, fused_k,
                      wait_ms/exec_ms) and the lease epoch; an
                      enforced tenant-quota violation is 429 +
                      retryable. Metrics: serving.interactive.*
                      (docs/monitoring.md); p95 SLO via
                      obs.slo.SLO(metric=
                      "serving.interactive.latency_ms").
  POST   /jobs      — submit an async OLAP job (olap/serving): body
                      {"kind": "bfs", "source": <vertex id>, ...,
                       "priority": 0, "timeout_s": 30, "deadline_s": 60,
                       "targets": [ids], "max_retries": 0,
                       "checkpoint_every": 0, "tenant": "team-a"}
                      → 202 {"job": id}.
                      Same-snapshot BFS jobs fuse into one batched
                      [K, n] device run; max_retries/checkpoint_every
                      opt into the recovery plane (olap/recovery —
                      RETRYING + resume-from-checkpoint; checkpoints
                      need a scheduler with checkpoint_dir set).
                      ``tenant`` (optional, defaults "default")
                      attributes the job's resources and labels its
                      metrics/trace; a submit refused by a tenant
                      quota (scheduler with enforce_quotas=True) is
                      429 + retryable.
  GET    /jobs      — scheduler stats + job summaries (each job's
                      ``epoch`` records the graph state it ran at —
                      live-plane leases carry compaction epoch +
                      overlay delta seq)
  GET    /live      — live graph plane stats (olap/live): freshness
                      lag (epochs/seconds), overlay fill + tombstone
                      fraction, compaction/resync/backpressure
                      counters, apply/compact latency percentiles;
                      {"enabled": false} without a live scheduler
  GET    /jobs/<id> — job status/result/metrics envelope (incl. attempt
                      / checkpoint_round / rounds_replayed / retry_at
                      for jobs on the recovery plane)
  DELETE /jobs/<id> — cancel (queued or retrying: immediate; running:
                      at the next level boundary via the per-job
                      early-exit mask)
  GET  /tenants     — per-tenant attribution + quota view:
                      queue-ms / device-seconds / HBM byte-seconds /
                      replayed rounds / in-flight and admission
                      counts per tenant, plus the configured quotas
                      and the enforcement flag
  GET  /slo         — SLO engine report (obs/slo): per objective the
                      current SLI and multi-window error-budget burn
                      rates; {"enabled": false} when the scheduler has
                      no objectives attached
  GET  /controller  — the autotune decision plane (olap/serving/
                      autotune): mode (shadow/enforce),
                      current knob values (batch K target, per-tenant
                      quota scales, checkpoint cadence), armed
                      cooldowns, and the bounded decision journal —
                      each entry carries the signal snapshot it read,
                      the rule id, old→new and its cooldown, so every
                      decision is reconstructible from the entry
                      alone; {"enabled": false} without a live
                      scheduler or with autotune="off"
  GET  /healthz     — liveness + readiness (the health-check hook
                      a replica fleet needs): 200 when ready, 503
                      with per-check detail otherwise. Ready ⇔ the
                      scheduler is open with a live worker, the
                      snapshot pool can hand out a current-epoch
                      snapshot, and the live plane's ledger is not
                      degraded into host-merge fallback. This is the
                      ONE probe that lazily constructs the scheduler —
                      readiness means "this replica can serve", so the
                      probe warms the serving stack on purpose.
  POST /debug/dump  — on-demand postmortem bundle (obs/flightrec):
                      body {"job": <id>} (optional) → 200 {"path"}.
                      409 when the scheduler has no flight recorder
                      (flight_dir / TITAN_TPU_FLIGHT_DIR unset).
  GET  /debug/dumps — index of postmortem bundles in the dump
                      directory (file/bytes/mtime, newest first);
                      {"enabled": false} without a recorder
  GET  /metrics     — Prometheus text exposition of every registered
                      counter/timer/histogram/gauge, labeled children
                      included (titan_tpu_torch/obs/promexport;
                      content type ``text/plain; version=0.0.4``).
                      With ``?federate=1`` and a Federator attached
                      (obs/federate), registered peers' registries are
                      scraped and merged in under ``instance`` labels —
                      one scrape target for the whole fleet
  GET  /fleet       — federation health roll-up: per registered peer,
                      up/evicted/consecutive-failures + its own
                      /healthz body; {"enabled": false} without a
                      Federator (docs/monitoring.md)
  GET  /trace?job=<id> — the job's span tree as JSON (obs/tracing:
                      submit→queue→fuse→per-round→checkpoint→retrying→
                      resume→terminal; 404 for unknown traces; the
                      reserved id ``live`` holds the live plane's
                      apply/compaction timeline; distributed scans
                      return ONE stitched tree — remote worker spans
                      spliced under the coordinator's split spans via
                      Tracer.ingest, marked ``remote``/``instance``).
                      Each ``GET /jobs``
                      entry also carries a ``trace`` digest
                      (queue_ms / fuse_ms / device_ms / rounds).
                      docs/observability.md documents the span model.
  GET /trace/export?job=<id> — drain the trace's COMPLETED spans
                      exactly once as wire dicts, framed with
                      t_recv/t_send anchors (docs/fleet.md: the
                      FleetRouter polls this on each replica and
                      splices the spans into its own stitched tree
                      via Tracer.ingest — including a dead replica's
                      partial spans next to the redispatch span)

Server config is a YAML file (gremlin-server.yaml analog):
  host: 127.0.0.1
  port: 8182
  graph:
    storage.backend: sqlite
    storage.directory: /data/graph
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler
from typing import Any, Optional

import numpy as np
import torch

from titan_tpu_torch.core.elements import Edge, Vertex, VertexProperty
from titan_tpu_torch.utils.httpnode import NodeHTTPServer

_EVAL_TIMEOUT_NOTE = "script evaluation runs in-request"


def jsonify(obj: Any, max_depth: int = 4) -> Any:
    """Traversal results → JSON-safe structures (GraphSON-flavored
    element envelopes; reference: TitanIoRegistry / GraphSON mapping)."""
    if max_depth < 0:
        return str(obj)
    if isinstance(obj, Vertex):
        return {"@type": "vertex", "id": obj.id, "label": obj.label()}
    if isinstance(obj, Edge):
        return {"@type": "edge", "id": obj.id, "label": obj.label(),
                "outV": obj.out_vertex().id, "inV": obj.in_vertex().id}
    if isinstance(obj, VertexProperty):
        return {"@type": "property", "key": obj.key(), "value": obj.value}
    if isinstance(obj, dict):
        return {str(k): jsonify(v, max_depth - 1) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [jsonify(v, max_depth - 1) for v in obj]
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    if isinstance(obj, (np.generic, np.ndarray, torch.Tensor)):
        # a numpy or torch value leaves as the Python value it holds
        # (never its repr): the wire carries what the JAX package's does
        if isinstance(obj, torch.Tensor):
            obj = obj.detach().cpu().numpy()
        return jsonify(obj.tolist(), max_depth)
    return str(obj)


def wire_error(e: BaseException) -> tuple[int, dict]:
    """Exception -> (HTTP status, error envelope): the wire taxonomy.

    Mirrors the backend exception taxonomy (reference: Temporary vs
    PermanentBackendException + BackendOperation retry semantics): 503 =
    retryable backend trouble, 400 = the caller's request is at fault,
    500 = server-side permanent. ``retryable`` tells clients whether the
    same request may succeed later."""
    from titan_tpu_torch.errors import (InvalidElementError,
                                  PermanentBackendError,
                                  SchemaViolationError,
                                  TemporaryBackendError)
    from titan_tpu_torch.olap.serving.tenants import QuotaExceeded
    name = type(e).__name__
    env = {"error": str(e) or name, "type": name}
    if isinstance(e, QuotaExceeded):
        # checked BEFORE the ValueError family it subclasses: a quota
        # refusal is 429 + retryable (the same request may succeed once
        # the tenant's load drains), never a 400 caller error
        return 429, {**env, "retryable": True}
    if isinstance(e, TemporaryBackendError):
        return 503, {**env, "retryable": True}
    if isinstance(e, (SchemaViolationError, InvalidElementError,
                      SyntaxError, NameError, TypeError, ValueError,
                      KeyError, AttributeError)):
        return 400, {**env, "retryable": False}
    if isinstance(e, PermanentBackendError):
        return 500, {**env, "retryable": False}
    return 500, {**env, "retryable": False}


def _ledger_ok(live_stats: Optional[dict]) -> bool:
    """The /healthz "ledger not in fallback" check: with no live plane
    there is no fallback state to be in; with one, ready means the
    compactor's LAST merge was not a host fallback while device
    merging is configured on (a host-mode epoch under device_merge
    means the ledger could not hold two epochs — serving limps, the
    replica should shed load until compaction recovers)."""
    if live_stats is None:
        return True
    comp = live_stats.get("compactor") or {}
    if not comp.get("device_merge", False):
        return True
    return comp.get("merge_mode") != "host"


class GraphServer:
    """Hosts one open graph; evaluate() is the script-engine seam.

    ``auth_token``: when set, every request must carry
    ``Authorization: Bearer <token>`` (401 otherwise) — the minimal
    credential gate for a script-evaluating endpoint. ``device`` goes to
    the scheduler that :meth:`scheduler` builds when none was given:
    None means CUDA, and raises without a card."""

    def __init__(self, graph, host: str = "127.0.0.1", port: int = 8182,
                 auth_token: Optional[str] = None, scheduler=None,
                 federator=None, device=None):
        self.graph = graph
        self.device = device
        self.host = host
        self.port = port
        self.auth_token = auth_token
        self._httpd: Optional[NodeHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._scheduler = scheduler
        self._sched_lock = threading.Lock()
        # optional obs.federate.Federator: when attached,
        # GET /metrics?federate=1 merges registered peers' registries
        # under instance labels and GET /fleet rolls up their health
        self.federator = federator

    # -- async job plane (olap/serving) --------------------------------------

    def scheduler(self):
        """The server's job scheduler, created lazily on the first /jobs
        request (tests may inject one — e.g. autostart=False to pin
        batch composition)."""
        with self._sched_lock:
            if self._scheduler is None or self._scheduler.closed:
                from titan_tpu_torch.olap.serving.scheduler import \
                    JobScheduler
                self._scheduler = JobScheduler(graph=self.graph,
                                               device=self.device)
            return self._scheduler

    def metrics_manager(self):
        """The registry ``GET /metrics`` scrapes: the scheduler's when
        one is live (tests inject isolated managers through it), else
        the graph's, else the process-wide singleton — WITHOUT lazily
        constructing a scheduler just to serve a scrape."""
        with self._sched_lock:
            sched = self._scheduler
        if sched is not None and not sched.closed:
            return sched._metrics
        if getattr(self.graph, "_metrics", None) is not None:
            return self.graph._metrics
        from titan_tpu_torch.utils.metrics import MetricManager
        return MetricManager.instance()

    def tracer(self):
        """The live scheduler's tracer, or None — WITHOUT lazily
        constructing a scheduler (a /trace probe on an idle server must
        not spin up a worker thread just to 404)."""
        with self._sched_lock:
            sched = self._scheduler
        return sched.tracer if sched is not None and not sched.closed \
            else None

    def live_scheduler(self):
        """The scheduler if one is alive, else None — the read-only
        observation endpoints (/tenants, /slo) answer from this so a
        monitoring probe never constructs a worker thread + pool +
        ledger just to report an empty plane."""
        with self._sched_lock:
            sched = self._scheduler
        return sched if sched is not None and not sched.closed else None

    def health(self) -> tuple[bool, dict]:
        """Readiness evaluation behind ``GET /healthz`` (unit-testable
        without HTTP). Intentionally constructs the scheduler when
        missing: readiness asserts "this replica can serve", which
        includes being able to stand the serving stack up."""
        checks: dict = {}
        try:
            sched = self.scheduler()
        except Exception as e:
            checks["scheduler"] = f"error: {type(e).__name__}: {e}"
            return False, checks
        worker = sched._worker
        checks["scheduler_open"] = ok_sched = (
            not sched.closed
            and worker is not None and worker.is_alive())
        pool_ok, why = sched.pool.ready()
        checks["snapshot_pool"] = why
        try:
            live = sched.live_stats()
        except Exception:
            live = None
        checks["ledger_ok"] = lok = _ledger_ok(live)
        return ok_sched and pool_ok and lok, checks

    def submit_job(self, body: dict):
        """Wire body → JobSpec → scheduler (shared by POST /jobs and the
        smoke script). ``deadline_s`` is relative to now; params carry
        kind-specific fields (source, targets, iterations, ...)."""
        import time as _time

        from titan_tpu_torch.olap.api import JobSpec
        kind = body.get("kind", "bfs")
        params = dict(body.get("params") or {})
        for key in ("source", "source_dense", "targets", "max_levels",
                    "iterations", "damping", "delta", "quantile_mass"):
            if key in body:
                params[key] = body[key]
        deadline = None
        if body.get("deadline_s") is not None:
            deadline = _time.time() + float(body["deadline_s"])
        # numeric fields are coerced HERE, at the untrusted boundary — a
        # string timeout_s would otherwise detonate inside the fused
        # batch's level callback and fail every batchmate
        timeout_s = None
        if body.get("timeout_s") is not None:
            timeout_s = float(body["timeout_s"])
        if "max_levels" in params:
            params["max_levels"] = int(params["max_levels"])
        spec = JobSpec(kind=kind, params=params,
                       priority=int(body.get("priority", 0)),
                       deadline=deadline,
                       timeout_s=timeout_s,
                       labels=body.get("labels"),
                       edge_keys=tuple(body.get("edge_keys") or ()),
                       directed=bool(body.get("directed", False)),
                       max_retries=int(body.get("max_retries", 0)),
                       checkpoint_every=int(
                           body.get("checkpoint_every", 0)),
                       tenant=body.get("tenant"),
                       idempotency_key=(
                           str(body["idempotency_key"])
                           if body.get("idempotency_key") else None))
        return self.scheduler().submit(spec)

    # -- interactive point-query lane (olap/serving/interactive) -------------

    def _script_traversal(self, script: str):
        """Evaluate a gremlin script to a LAZY dsl Traversal (no
        execution, no transaction side effects — building a chain only
        appends steps)."""
        from titan_tpu_torch.query.predicates import P
        from titan_tpu_torch.traversal import dsl as _dsl
        from titan_tpu_torch.traversal.dsl import Traversal
        bindings = {"g": self.graph.traversal(), "P": P,
                    "anon": _dsl.anon, "__": getattr(_dsl, "__"),
                    "__builtins__": {}}
        t = eval(script, bindings)  # noqa: S307 — same trust model as
        #                             POST /traversal (script endpoint)
        if not isinstance(t, Traversal):
            raise ValueError("'gremlin' must evaluate to a traversal "
                             "chain (got " + type(t).__name__ + ")")
        return t

    def _interpret(self, t) -> Any:
        """Run a dsl traversal on the interpreter with the same
        per-request transaction semantics as ``evaluate``."""
        try:
            out = t.to_list()
            self.graph.commit()
            return out
        except BaseException:
            self.graph.rollback()
            raise

    def traverse(self, body: dict) -> dict:
        """``POST /traverse`` core (unit-testable without HTTP):
        compile → fuse → device run; chains outside the compilable
        subset (or runtime FallbackToInterpreter) answer via the dsl
        interpreter with ``"fallback": true`` — loud, never silent."""
        from titan_tpu_torch.olap.serving.interactive import (
            FallbackToInterpreter, TraversalPlan, compile_traversal,
            plan_from_wire, traversal_from_plan)
        tenant = body.get("tenant")
        timeout_s = float(body.get("timeout_s", 30.0))
        lane = self.scheduler().interactive()
        fallback_t = None
        why = None
        accounted = False      # did lane.submit already admit/account?
        if "gremlin" in body:
            fallback_t = self._script_traversal(body["gremlin"])
            plan = compile_traversal(fallback_t, lane.max_depth)
            if plan is None:
                why = "chain outside the compilable subset"
        else:
            plan = plan_from_wire(body)
        if plan is not None:
            try:
                res = lane.submit(plan, tenant=tenant,
                                  timeout_s=timeout_s)
                res["result"] = jsonify(res["result"])
                res["fallback"] = False
                return res
            except FallbackToInterpreter as e:
                why = str(e)
                accounted = True     # submit admitted + finished it
                if fallback_t is None and isinstance(plan,
                                                     TraversalPlan):
                    fallback_t = traversal_from_plan(
                        plan, self.graph.traversal())
        if fallback_t is None:
            # a ppr plan has no interpreter twin: surface the reason
            raise ValueError(f"cannot serve request: {why}")
        # the interpreter ride flows through the SAME tenant quota gate
        # as compiled traffic (an enforced over-quota tenant gets 429
        # for uncompilable chains too, QuotaExceeded propagating);
        # runtime fallbacks were already admitted by lane.submit
        done = None if accounted else lane.account_fallback(tenant)
        try:
            out = self._interpret(fallback_t)
        except BaseException:
            if done is not None:
                done("failed")
            raise
        if done is not None:
            done("fallback")
        if isinstance(plan, TraversalPlan) and plan.terminal == "count":
            out = out[0] if out else 0
        return {"result": jsonify(out), "fallback": True, "why": why}

    # -- script evaluation ---------------------------------------------------

    def evaluate(self, script: str) -> Any:
        """One traversal script against fresh bindings; the thread-bound tx
        commits on success, rolls back on error (Gremlin Server's
        per-request transaction semantics)."""
        from titan_tpu_torch.query.predicates import P
        from titan_tpu_torch.traversal import dsl as _dsl
        bindings = {"g": self.graph.traversal(), "graph": self.graph,
                    "P": P, "anon": _dsl.anon,
                    # TP3 __ helper for union/coalesce/repeat/match bodies
                    "__": getattr(_dsl, "__"),
                    "__builtins__": {"len": len, "list": list,
                                     "range": range, "sorted": sorted,
                                     "min": min, "max": max,
                                     "sum": sum}}
        try:
            result = eval(script, bindings)  # noqa: S307 — script endpoint
            from titan_tpu_torch.traversal.dsl import Traversal
            if isinstance(result, Traversal):
                result = result.to_list()
            self.graph.commit()
            return result
        except BaseException:
            self.graph.rollback()
            raise

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "GraphServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_text(self, code: int, text: str,
                           content_type: str) -> None:
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self) -> bool:
                if server.auth_token is None:
                    return True
                import hmac
                got = self.headers.get("Authorization", "")
                if hmac.compare_digest(got,
                                       f"Bearer {server.auth_token}"):
                    return True
                self._send(401, {"error": "missing or bad bearer token",
                                 "type": "Unauthorized",
                                 "retryable": False})
                return False

            def do_GET(self):
                if not self._authorized():
                    return
                try:
                    self._do_get()
                except BaseException as e:
                    # same JSON-error contract as /traversal — never drop
                    # the connection on a backend hiccup
                    try:
                        self._send(*wire_error(e))
                    except OSError:
                        pass

            def _do_get(self):
                if self.path == "/status":
                    from titan_tpu_torch.config import defaults as d
                    g = server.graph
                    metrics = {}
                    if g._metrics is not None:
                        # counter values only, as before the unified
                        # snapshot schema (full stats live on /metrics)
                        metrics = {k: v["count"] for k, v in
                                   g._metrics.snapshot().items()
                                   if v["type"] == "counter"}
                    self._send(200, {
                        "instance": g.instance_id,
                        "backend": g.backend.manager.name,
                        "computer": g.config.get(d.COMPUTER_BACKEND),
                        "metrics": metrics})
                elif self.path == "/healthz":
                    ready, checks = server.health()
                    self._send(200 if ready else 503,
                               {"live": True, "ready": ready,
                                "checks": checks})
                elif self.path == "/debug/dumps":
                    # postmortem index (obs/flightrec) — answered from
                    # the live scheduler only (a monitoring probe must
                    # not construct one; cf. /tenants)
                    sched = server.live_scheduler()
                    rec = sched.recorder if sched is not None else None
                    if rec is None:
                        self._send(200, {"enabled": False, "dumps": []})
                    else:
                        self._send(200, {"enabled": True,
                                         "dump_dir": rec.dump_dir,
                                         "dumps": rec.index()})
                elif self.path.split("?", 1)[0] == "/metrics":
                    from urllib.parse import parse_qs, urlparse
                    from titan_tpu_torch.obs.promexport import (
                        CONTENT_TYPE, render_prometheus)
                    body = render_prometheus(server.metrics_manager())
                    q = parse_qs(urlparse(self.path).query)
                    fed = server.federator
                    if fed is not None and (q.get("federate")
                                            or ["0"])[0] not in (
                                                "0", "", "false"):
                        # scrape-then-render so the merged body is one
                        # coherent round across the fleet
                        fed.scrape()
                        body = fed.render(body)
                    self._send_text(200, body, CONTENT_TYPE)
                elif self.path == "/fleet":
                    fed = server.federator
                    if fed is None:
                        self._send(200, {"enabled": False, "peers": []})
                    else:
                        fed.scrape()
                        self._send(200, {"enabled": True,
                                         **fed.fleet()})
                elif self.path.split("?", 1)[0] == "/trace/export":
                    # fleet trace splice (olap/fleet): pop this trace's
                    # COMPLETED spans exactly once, framed with local
                    # receive/send anchors so the router's Tracer.ingest
                    # can NTP-normalize remote clocks — the worker side
                    # of the scan_worker /trace/drain idiom, for jobs
                    import time as _time
                    from urllib.parse import parse_qs, urlparse
                    q = parse_qs(urlparse(self.path).query)
                    tid = (q.get("job") or [None])[0]
                    if tid is None:
                        self._send(400, {"error": "trace/export needs "
                                                  "?job=<id>",
                                         "type": "BadRequest",
                                         "retryable": False})
                        return
                    t_recv = _time.time()
                    tracer = server.tracer()
                    spans, dropped = tracer.drain(tid) \
                        if tracer is not None else ([], 0)
                    self._send(200, {"trace": tid, "spans": spans,
                                     "dropped": dropped,
                                     "t_recv": t_recv,
                                     "t_send": _time.time()})
                elif self.path.split("?", 1)[0] == "/trace":
                    from urllib.parse import parse_qs, urlparse
                    q = parse_qs(urlparse(self.path).query)
                    tid = (q.get("job") or [None])[0]
                    if tid is None:
                        self._send(400, {"error": "trace needs "
                                                  "?job=<id>",
                                         "type": "BadRequest",
                                         "retryable": False})
                        return
                    tracer = server.tracer()
                    tree = tracer.tree(tid) if tracer is not None \
                        else None
                    if tree is None:
                        self._send(404, {"error": f"unknown trace "
                                                  f"{tid!r} (tracing "
                                                  f"disabled, evicted, "
                                                  f"or never a job)",
                                         "type": "NotFound",
                                         "retryable": False})
                    else:
                        self._send(200, tree)
                elif self.path == "/schema":
                    types = server.graph.schema.all_types()
                    self._send(200, {"types": [
                        {"name": t.name, "id": t.id,
                         "kind": type(t).__name__} for t in types]})
                elif self.path == "/jobs":
                    sched = server.scheduler()
                    jobs = []
                    for j in sched.jobs():
                        w = j.to_wire()
                        ts = sched.trace_summary(j.id)
                        if ts is not None:
                            w["trace"] = ts
                        jobs.append(w)
                    self._send(200, {"stats": sched.stats(),
                                     "jobs": jobs})
                elif self.path == "/live":
                    # live plane observability (olap/live): freshness
                    # lag, overlay fill, compaction/backpressure
                    # counters — serving.live.* as one JSON envelope
                    live = server.scheduler().live_stats()
                    if live is None:
                        self._send(200, {"enabled": False})
                    else:
                        self._send(200, {"enabled": True, **live})
                elif self.path == "/controller":
                    # autotune decision plane (olap/serving/autotune):
                    # knob state + the explainable decision journal —
                    # answered from the LIVE scheduler only (a probe
                    # must not construct one; cf. /tenants)
                    sched = server.live_scheduler()
                    ctl = sched.controller if sched is not None \
                        else None
                    if ctl is None:
                        self._send(200, {"enabled": False})
                    else:
                        self._send(200, {"enabled": True,
                                         **ctl.state()})
                elif self.path == "/tenants":
                    # per-tenant attribution + quota view:
                    # accounting rows, configured quotas, enforcement —
                    # answered from the LIVE scheduler only (a probe
                    # must not construct one; cf. metrics_manager)
                    sched = server.live_scheduler()
                    self._send(200, sched.tenant_stats()
                               if sched is not None
                               else {"enforce_quotas": False,
                                     "tenants": {}, "quotas": {}})
                elif self.path == "/slo":
                    # SLO engine report: per objective, current SLI +
                    # multi-window error-budget burn rates
                    sched = server.live_scheduler()
                    slo = sched.slo_report() if sched is not None \
                        else None
                    if slo is None:
                        self._send(200, {"enabled": False})
                    else:
                        self._send(200, {"enabled": True, **slo})
                elif self.path.startswith("/jobs/"):
                    sched = server.scheduler()
                    job = sched.get(self.path[len("/jobs/"):])
                    if job is None:
                        self._send(404, {"error": "unknown job",
                                         "type": "NotFound",
                                         "retryable": False})
                    else:
                        w = job.to_wire()
                        ts = sched.trace_summary(job.id)
                        if ts is not None:
                            w["trace"] = ts
                        self._send(200, w)
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if not self._authorized():
                    return
                if self.path not in ("/traversal", "/jobs",
                                     "/traverse", "/debug/dump"):
                    self._send(404, {"error": f"unknown path {self.path}",
                                     "type": "NotFound",
                                     "retryable": False})
                    return
                length = int(self.headers.get("Content-Length", 0))
                if self.path == "/traverse":
                    from titan_tpu_torch.olap.serving.tenants import \
                        QuotaExceeded
                    try:
                        body = json.loads(
                            self.rfile.read(length) or b"{}")
                        if not isinstance(body, dict):
                            raise ValueError(
                                "body must be a JSON object")
                        res = server.traverse(body)
                    except QuotaExceeded as e:
                        # before its ValueError parent: 429 + retryable
                        self._send(*wire_error(e))
                        return
                    except (json.JSONDecodeError, ValueError,
                            TypeError, SyntaxError, NameError) as e:
                        self._send(400, {"error": str(e),
                                         "type": type(e).__name__,
                                         "retryable": False})
                        return
                    except BaseException as e:
                        self._send(*wire_error(e))
                        return
                    self._send(200, res)
                    return
                if self.path == "/debug/dump":
                    # on-demand postmortem: dump the flight ring + full
                    # system state now, optionally anchored to a job
                    sched = server.live_scheduler()
                    if sched is None or sched.recorder is None:
                        self._send(409, {
                            "error": "flight recorder disabled — start "
                                     "the scheduler with flight_dir= "
                                     "(or TITAN_TPU_FLIGHT_DIR)",
                            "type": "Conflict", "retryable": False})
                        return
                    try:
                        body = json.loads(
                            self.rfile.read(length) or b"{}")
                        if not isinstance(body, dict):
                            raise ValueError(
                                "body must be a JSON object")
                        path = sched.dump_debug(body.get("job"))
                    except (json.JSONDecodeError, ValueError) as e:
                        self._send(400, {"error": str(e),
                                         "type": type(e).__name__,
                                         "retryable": False})
                        return
                    except BaseException as e:
                        self._send(*wire_error(e))
                        return
                    import os as _os
                    self._send(200, {"path": path,
                                     "file": _os.path.basename(path)})
                    return
                if self.path == "/jobs":
                    from titan_tpu_torch.olap.serving.tenants import \
                        QuotaExceeded
                    try:
                        body = json.loads(self.rfile.read(length) or b"{}")
                        job = server.submit_job(body)
                    except QuotaExceeded as e:
                        # before its ValueError parent: 429 + retryable
                        self._send(*wire_error(e))
                        return
                    except (json.JSONDecodeError, ValueError,
                            TypeError) as e:
                        self._send(400, {"error": str(e),
                                         "type": type(e).__name__,
                                         "retryable": False})
                        return
                    except BaseException as e:
                        self._send(*wire_error(e))
                        return
                    self._send(202, job.to_wire())
                    return
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                    script = req["gremlin"]
                except (json.JSONDecodeError, KeyError):
                    self._send(400, {"error": "body must be JSON with a "
                                              "'gremlin' field",
                                     "type": "BadRequest",
                                     "retryable": False})
                    return
                try:
                    result = server.evaluate(script)
                except BaseException as e:
                    self._send(*wire_error(e))
                    return
                self._send(200, {"result": jsonify(result)})

            def do_DELETE(self):
                if not self._authorized():
                    return
                if not self.path.startswith("/jobs/"):
                    self._send(404, {"error": f"unknown path {self.path}",
                                     "type": "NotFound",
                                     "retryable": False})
                    return
                sched = server.scheduler()
                job_id = self.path[len("/jobs/"):]
                job = sched.get(job_id)
                if job is None:
                    self._send(404, {"error": "unknown job",
                                     "type": "NotFound",
                                     "retryable": False})
                elif sched.cancel(job_id):
                    self._send(200, job.to_wire())
                else:
                    self._send(409, {"error": f"job already "
                                              f"{job.state.value}",
                                     "type": "Conflict",
                                     "retryable": False,
                                     **job.to_wire()})

        self._httpd = NodeHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]   # resolve port 0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="titan-tpu-torch-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        with self._sched_lock:
            if self._scheduler is not None and not self._scheduler.closed:
                self._scheduler.close()


def from_yaml(path: str) -> GraphServer:
    """gremlin-server.yaml analog → a ready (unstarted) GraphServer."""
    import yaml

    import titan_tpu_torch
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    graph = titan_tpu_torch.open(cfg.get("graph") or {})
    return GraphServer(graph, host=cfg.get("host", "127.0.0.1"),
                       port=int(cfg.get("port", 8182)),
                       auth_token=cfg.get("auth-token"))


def console(config) -> None:
    """Interactive console with an open graph bound as ``g``/``graph``
    (reference: gremlin.sh + TitanGremlinPlugin console imports)."""
    import code

    import titan_tpu_torch
    from titan_tpu_torch.query.predicates import P
    from titan_tpu_torch.traversal import dsl as _dsl
    graph = titan_tpu_torch.open(config)
    banner = (f"titan_tpu_torch console — graph open on "
              f"{graph.backend.manager.name}\n"
              f"bindings: graph, g (traversal), P (predicates), mgmt, "
              f"__/anon (sub-traversals)")
    try:
        code.interact(banner=banner, local={
            "graph": graph, "g": graph.traversal(), "P": P,
            "mgmt": graph.management(), "anon": _dsl.anon,
            "__": getattr(_dsl, "__")})
    finally:
        graph.close()


def main(argv: Optional[list] = None) -> None:
    """``python -m titan_tpu_torch.server conf.yaml`` or
    ``python -m titan_tpu_torch.server --console inmemory``."""
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "--console":
        console(args[1] if len(args) > 1 else "inmemory")
        return
    if not args:
        print("usage: python -m titan_tpu_torch.server <conf.yaml> | "
              "--console <backend>", file=sys.stderr)
        raise SystemExit(2)
    server = from_yaml(args[0]).start()
    print(f"titan_tpu_torch server listening on "
          f"{server.host}:{server.port}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
