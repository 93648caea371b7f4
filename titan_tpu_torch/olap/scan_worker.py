"""Multi-host distributed scan: HTTP scan workers + a failover coordinator.

Completes the distributed-OLAP tier past one host (reference:
titan-hadoop-core scan/HadoopScanMapper.java:33-110 runs any ScanJob in
YARN containers across a cluster; MapReduceIndexManagement.java:50 drives
REINDEX/REMOVE that way). Here the container role is a long-lived
**scan worker node** (``python -m titan_tpu_torch.olap.scan_worker``) on each
host: the coordinator splits the key space on partition boundaries
(olap/distributed.key_splits), ships each split as a ScanJobSpec over
HTTP, and merges the returned ScanMetrics — with re-dispatch of a dead
worker's splits to the survivors, the Hadoop re-run-failed-mapper
semantics (split scans are idempotent).

Workers open their own graph connection per request from the shipped
config, exactly like HadoopScanMapper.setup reconstructs the job from
serialized config; pointing that config at a ``remote``/``remote-cluster``
backend gives a true multi-host scan against shared storage nodes.

Observability: the path reports through the registry (``scan.remote.*``,
visible on ``GET /metrics``):
splits dispatched / merged / re-dispatched, per-``{url}`` worker
failures, and splits served on the worker side; pass ``tracer=`` (an
``obs.tracing.Tracer``) to additionally journal one span per split
under the reserved trace id ``"scan"`` (url, key-range size, ok/error
— the re-dispatch timeline end to end).

Cross-process tracing: with a tracer attached the
coordinator also stamps a W3C-style ``traceparent`` into every split
request; the worker runs its OWN tracer, parents its split / execute /
serialize spans under the propagated context, and ships the completed
spans back in the split response — the coordinator splices them into
the owning trace with clock-skew normalization
(``Tracer.ingest``), so ``GET /trace`` renders ONE tree spanning both
processes. Workers additionally expose ``GET /metrics`` (Prometheus
text), ``GET /healthz``, and a bounded ``POST /trace/drain`` for
fire-and-forget span pickup; ``obs.federate.Federator`` scrapes those
into the coordinator's ``GET /metrics?federate=1``. Propagation is
opt-out (``propagate=False``) and changes no scan results — only what
the trace can show.

The port's copy of ``titan_tpu/olap/scan_worker.py``: run a worker with
``python -m titan_tpu_torch.olap.scan_worker [PORT] [HOST]``. Its allowlist
defaults to ``titan_tpu_torch.``; a factory under the JAX package is
refused as a fault of the job (HTTP 500, ``PermanentBackendError`` at the
coordinator) before anything is imported.
"""

from __future__ import annotations

import base64
import itertools
import queue
import threading
import time
from typing import Optional, Sequence

from titan_tpu_torch.errors import PermanentBackendError, TemporaryBackendError
from titan_tpu_torch.obs.tracing import (INGEST_MAX_SPANS, Tracer,
                                         make_traceparent, parse_traceparent)
from titan_tpu_torch.olap.api import ScanMetrics
from titan_tpu_torch.olap.distributed import (ScanJobSpec, _merge_metrics,
                                              _run_split, key_splits)
from titan_tpu_torch.utils.httpnode import JsonNode, TextResponse, json_call
from titan_tpu_torch.utils.metrics import MetricManager


def _b(x: bytes) -> str:
    return base64.b64encode(x).decode()


def _ub(x: str) -> bytes:
    return base64.b64decode(x)


class ScanWorkerServer(JsonNode):
    """One scan worker: executes shipped splits against its own graph
    connection (opened per request from the shipped config).

    The shipped ``factory`` ("module:callable") is code selection, so the
    worker gates it twice: the JsonNode bearer token (TITAN_TPU_NODE_TOKEN
    or ``auth_token=``) authenticates the caller, and ``factory_allow``
    restricts resolution to registered prefixes (default: the built-in
    ``titan_tpu_torch.`` jobs; extend via the TITAN_TPU_SCAN_FACTORIES env
    var, comma-separated module prefixes)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 auth_token: Optional[str] = None,
                 factory_allow: Optional[Sequence[str]] = None,
                 metrics: Optional[MetricManager] = None,
                 tracer: Optional[Tracer] = None):
        super().__init__(self._dispatch, host, port, name="scan-worker",
                         auth_token=auth_token)
        self._metrics = metrics or MetricManager.instance()
        # the worker's OWN span journal: split requests that carry a
        # traceparent journal under a per-request key and drain into
        # the response; without one the worker records nothing
        self.tracer = tracer or Tracer()
        self._req_ids = itertools.count(1)
        if factory_allow is None:
            import os
            extra = [p.strip() for p in
                     os.environ.get("TITAN_TPU_SCAN_FACTORIES",
                                    "").split(",") if p.strip()]
            factory_allow = ["titan_tpu_torch."] + extra
        self.factory_allow = list(factory_allow)

    def _factory_allowed(self, factory: str) -> bool:
        # dot-anchored only: an allowlist entry "myjobs" must not also
        # admit sibling modules like "myjobs_evil"
        mod = factory.split(":", 1)[0]
        return any(mod == p.rstrip(".")
                   or mod.startswith(p.rstrip(".") + ".")
                   for p in self.factory_allow)

    def _dispatch(self, path: str, req: dict):
        path = path.split("?", 1)[0]
        if path == "/ping":
            return {"ok": True}
        if path == "/scan":
            return self._scan(req)
        if path == "/trace/drain":
            # bounded pickup for fire-and-forget spans: anything a
            # worker journaled that never rode a response (the caller
            # names the trace key it handed out)
            tid = str(req.get("trace") or "")
            if not tid:
                raise ValueError("trace/drain needs {'trace': <id>}")
            cap = min(int(req.get("max_spans", INGEST_MAX_SPANS)),
                      INGEST_MAX_SPANS)
            spans, dropped = self.tracer.drain(tid, max_spans=cap)
            return {"spans": spans, "dropped": dropped,
                    "t_now": time.time()}
        if path == "/metrics":
            # the federation scrape surface (obs/federate): this
            # worker's whole registry in Prometheus text
            from titan_tpu_torch.obs.promexport import (CONTENT_TYPE,
                                                        render_prometheus)
            return TextResponse(render_prometheus(self._metrics),
                                CONTENT_TYPE)
        if path == "/healthz":
            return {"live": True, "ready": True, "role": "scan-worker",
                    "splits_served": int(self._metrics.counter_value(
                        "scan.remote.splits_served"))}
        raise ValueError(f"unknown path {path!r}")

    def _scan(self, req: dict) -> dict:
        t_recv = time.time()
        if not self._factory_allowed(str(req["factory"])):
            raise PermanentBackendError(
                f"factory {req['factory']!r} not in the worker's "
                "allowlist (TITAN_TPU_SCAN_FACTORIES)")
        # propagated trace context → journal this split's spans under a
        # per-request key (concurrent splits of one trace must not
        # drain each other's spans) and ship them back in the response
        ctx = parse_traceparent(req.get("traceparent"))
        tracer = self.tracer if ctx is not None and \
            self.tracer is not None and self.tracer.enabled else None
        root = ex = None
        wkey = None
        if tracer is not None:
            # the propagated parent span id lives in the COORDINATOR's
            # id space (numerically colliding with this worker's own
            # ids), so the worker's root ships parentless — ingest
            # attaches unshipped parents under the coordinator's split
            # span, which IS the propagated parent
            wkey = f"{ctx[0]}#w{next(self._req_ids)}"
            root = tracer.start(wkey, "split",
                                factory=str(req["factory"]))
            ex = tracer.start(wkey, "execute", parent=root)
        spec = ScanJobSpec(req["factory"], dict(req.get("kwargs") or {}))
        key_range = (_ub(req["key_start"]), _ub(req["key_end"]))
        counts = _run_split(dict(req["graph_config"]), spec, key_range,
                            req.get("store", "edgestore"),
                            int(req.get("num_threads", 2)))
        self._metrics.counter("scan.remote.splits_served").inc()
        if tracer is None:
            return {"counts": {k: int(v) for k, v in counts.items()}}
        tracer.end(ex)
        ser = tracer.start(wkey, "serialize", parent=root)
        out = {"counts": {k: int(v) for k, v in counts.items()}}
        tracer.end(ser)
        tracer.end(root)
        spans, dropped = tracer.drain(wkey)
        out["trace"] = {"spans": spans, "dropped": dropped,
                        "t_recv": t_recv, "t_send": time.time()}
        return out


class RemoteScanRunner:
    """Coordinator: dispatches key splits to HTTP scan workers with
    failover. ``workers``: ["host:port", ...]."""

    def __init__(self, workers: Sequence[str], graph_config: dict,
                 store: str = "edgestore", threads_per_worker: int = 2,
                 splits_per_worker: int = 2, timeout: float = 600.0,
                 metrics: Optional[MetricManager] = None,
                 tracer=None, trace_id: str = "scan",
                 propagate: bool = True):
        if not workers:
            raise ValueError("RemoteScanRunner needs at least one worker")
        self.workers = [w if "://" in w else f"http://{w}" for w in workers]
        self.graph_config = dict(graph_config)
        self.store = store
        self.threads_per_worker = threads_per_worker
        self.splits_per_worker = splits_per_worker
        self.timeout = timeout
        self._metrics = metrics or MetricManager.instance()
        # optional span journal (obs/tracing.Tracer): one span per
        # split attempt under ``trace_id`` (default: the reserved
        # "scan" trace); with ``propagate`` the split's span id also
        # rides the request as a traceparent and the worker's spans
        # come back spliced under it (Tracer.ingest)
        self._tracer = tracer
        self.trace_id = trace_id
        self.propagate = bool(propagate)

    def _start_split(self, url: str):
        """Open the per-attempt ``split`` span (None without a tracer)
        — a dead worker's re-dispatch stays a visible timeline, not an
        inference from totals."""
        if self._tracer is None or not self._tracer.enabled:
            return None
        return self._tracer.start(self.trace_id, "split", url=url)

    def _end_split(self, span, **attrs) -> None:
        if span is not None:
            self._tracer.end(span, **attrs)

    def _ingest_trace(self, res: dict, span, url: str,
                      t0: float, t1: float) -> None:
        """Splice the worker's shipped spans under this attempt's split
        span. Skew anchor: the coordinator knows it sent at ``t0`` and
        received at ``t1``; the worker stamped its own receive/send —
        the NTP-style midpoint difference is the remote→local offset,
        and (t0, t1) is the clamp window that keeps the stitched tree
        monotonic even when that estimate is off."""
        wire = res.get("trace") if isinstance(res, dict) else None
        if wire is None or span is None:
            return
        try:
            offset = ((t0 + t1) - (float(wire["t_recv"])
                                   + float(wire["t_send"]))) / 2.0
        except (KeyError, TypeError, ValueError):
            offset = 0.0
        self._tracer.ingest(
            self.trace_id, wire.get("spans") or [],
            parent_id=span.span_id, offset=offset, window=(t0, t1),
            instance=url, extra_dropped=int(wire.get("dropped") or 0),
            metrics=self._metrics)

    def run(self, spec: ScanJobSpec, idm=None) -> ScanMetrics:
        if idm is None:
            import titan_tpu_torch
            g = titan_tpu_torch.open(dict(self.graph_config))
            try:
                idm = g.idm
            finally:
                g.close()
        splits = key_splits(idm,
                            len(self.workers) * self.splits_per_worker)
        pending: "queue.Queue" = queue.Queue()
        for s in splits:
            pending.put(s)
        results: list[dict] = []
        errors: list[BaseException] = []
        fatal: list[BaseException] = []
        done = threading.Event()
        lock = threading.Lock()
        remaining = [len(splits)]
        alive = [len(self.workers)]

        def serve(url: str):
            """One drain loop per worker: keep polling until every split
            has completed (another worker's failed split may be re-queued
            AFTER this worker first sees an empty queue, so idle workers
            must wait, not exit); a worker retires only on its own
            failure (re-run-mapper semantics). A PermanentBackendError is
            the JOB's fault (e.g. an unresolvable factory) — retrying on
            other workers cannot help, so the whole run aborts."""
            m = self._metrics
            while not done.is_set():
                try:
                    key_range = pending.get(timeout=0.2)
                except queue.Empty:
                    continue
                m.counter("scan.remote.splits_dispatched").inc()
                span = self._start_split(url)
                # skew anchors in the TRACER's clock domain (injectable
                # clock preserved): the NTP-style offset in
                # _ingest_trace maps worker wall time into whatever
                # clock this tracer runs on
                t0 = span.t_start if span is not None else time.time()
                payload = {
                    "graph_config": self.graph_config,
                    "factory": spec.factory, "kwargs": spec.kwargs,
                    "key_start": _b(key_range[0]),
                    "key_end": _b(key_range[1]),
                    "store": self.store,
                    "num_threads": self.threads_per_worker,
                }
                if span is not None and self.propagate:
                    payload["traceparent"] = make_traceparent(
                        self.trace_id, span.span_id)
                try:
                    res = json_call(url, "/scan", payload,
                                    timeout=self.timeout)
                except PermanentBackendError as e:
                    self._end_split(span, error=f"permanent: {e}")
                    with lock:
                        fatal.append(e)
                        done.set()
                    return
                except Exception as e:   # noqa: BLE001 — retire worker
                    # the split is idempotent: back on the queue for a
                    # survivor — COUNTED, so a flapping worker's
                    # re-dispatch churn shows on GET /metrics instead
                    # of hiding inside a slower wall clock
                    pending.put(key_range)
                    m.counter("scan.remote.splits_redispatched").inc()
                    m.counter("scan.remote.worker_failures",
                              labels={"url": url}).inc()
                    self._end_split(span, redispatched=True,
                                    error=f"{type(e).__name__}: {e}")
                    with lock:
                        errors.append(e)
                        alive[0] -= 1
                        if alive[0] == 0:
                            done.set()   # no one left to drain the queue
                    return
                t1 = self._tracer.clock() if span is not None \
                    else time.time()
                m.counter("scan.remote.splits_merged").inc()
                self._ingest_trace(res, span, url, t0, t1)
                self._end_split(span, ok=True)
                with lock:
                    results.append(res["counts"])
                    remaining[0] -= 1
                    if remaining[0] == 0:
                        done.set()

        threads = [threading.Thread(target=serve, args=(u,), daemon=True)
                   for u in self.workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if fatal:
            raise fatal[0]
        if remaining[0] > 0:
            raise TemporaryBackendError(
                f"{remaining[0]} split(s) undispatchable; all workers "
                f"failed (last errors: {[str(e) for e in errors[-3:]]})")
        metrics = ScanMetrics()
        for counts in results:
            _merge_metrics(metrics, counts)
        return metrics


def distributed_reindex_remote(workers: Sequence[str], graph_config: dict,
                               index_name: str) -> ScanMetrics:
    """REINDEX across HTTP scan workers (the MapReduceIndexManagement
    role at multi-host scale)."""
    runner = RemoteScanRunner(workers, graph_config)
    spec = ScanJobSpec("titan_tpu_torch.olap.distributed:make_repair_job",
                       {"index_name": index_name})
    return runner.run(spec)


def main(argv: Optional[list] = None) -> None:
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    port = int(args[0]) if args else 0
    # localhost by default: exposing the worker beyond the host is an
    # explicit decision and should come with a bearer token
    host = args[1] if len(args) > 1 else "127.0.0.1"
    node = ScanWorkerServer(host, port).start()
    if host not in ("127.0.0.1", "localhost") and node.auth_token is None:
        print("WARNING: scan-worker bound to a non-local interface with "
              "no TITAN_TPU_NODE_TOKEN set — any peer can submit scan "
              "jobs", file=sys.stderr)
    print(f"scan-worker serving on {node.url}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        node.stop()


if __name__ == "__main__":
    main()
