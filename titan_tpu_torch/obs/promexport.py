"""Prometheus text exposition for the ``utils.metrics`` registry.

Renders every registered counter / timer / histogram / gauge in the
exposition format (version 0.0.4 — the plaintext protocol every
Prometheus scraper speaks), served by ``GET /metrics`` on the HTTP
server:

* counters → ``# TYPE <name> counter`` + one sample; counters created
  with ``gauge=True`` (bidirectional bookkeeping like queue depth)
  render as gauges instead — the flag lives on the metric itself, not
  in an exporter-side name allowlist;
* timers   → a ``<name>_seconds`` summary (``_count`` / ``_sum``) plus
  ``<name>_seconds_max`` as a companion gauge — Prometheus summaries
  don't carry min/max, and the max is the number an SLO page wants;
* histograms → a summary with ``quantile="0.5"`` / ``"0.95"`` labels
  (the reservoir's nearest-rank percentiles) + ``_count`` / ``_sum``;
* gauges → ``# TYPE <name> gauge`` + one sample read from the callback
  at scrape time (HBM residency, snapshot-pool size, SLO burn rates).

Labeled children render as additional samples of the SAME
family with their label set attached (``serving_jobs_completed
{kind="bfs",tenant="a"}``); the unlabeled parent sample is the exact
sum of its children, so dashboards aggregate either way. ``# HELP``
lines come from the per-name ``HELP`` description registry below.

Metric names are sanitized to the Prometheus grammar (dots and every
other illegal character become ``_``); label values are escaped per the
exposition spec. The rendering is pure host-side string work off the
registry's snapshot views — one registry pass per scrape, no locks held
while writing the response.
"""

from __future__ import annotations

import re

from titan_tpu_torch.utils.metrics import MetricManager

#: the scrape response content type (text exposition format 0.0.4)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: per-name description registry behind the ``# HELP`` lines, word for
#: word the JAX package's, so the same registry renders byte-equal text
#: from both packages (a mixed fleet federates into one exposition)
HELP = {
    "serving.jobs.submitted": "jobs accepted by admission",
    "serving.jobs.rejected": "submits refused by admission",
    "serving.jobs.completed": "jobs that reached DONE",
    "serving.jobs.failed": "jobs that reached FAILED",
    "serving.jobs.timeout": "jobs that ran past their timeout_s",
    "serving.jobs.cancelled": "jobs cancelled by the caller",
    "serving.jobs.expired": "jobs whose start deadline passed queued",
    "serving.queue.depth": "current queue depth by priority class",
    "serving.job.latency_ms":
        "submit-to-terminal wall time (executed jobs only)",
    "serving.job.queue_ms": "submit-to-first-start wall time",
    "serving.batch.occupancy": "K per executed batch (fusion width)",
    "serving.tenant.rejected": "submits refused by a tenant quota",
    "serving.tenant.throttled":
        "quota violations admitted in shadow mode (enforcement off)",
    "serving.hbm.resident_bytes":
        "device bytes of graph images on the HBM ledger",
    "serving.hbm.pinned_bytes":
        "ledger bytes pinned under running batches",
    "serving.pool.snapshots": "snapshots resident in the serving pool",
    "serving.slo.burn_rate":
        "error-budget burn rate per objective and window",
    "metrics.labels.dropped":
        "labeled lookups degraded to their unlabeled parent by the "
        "per-name cardinality cap",
    "device.compile.count":
        "XLA compilations (one per kernel x static shape bucket), "
        "by kernel",
    "device.compile.cache_hits":
        "profiled kernel calls served from the jit cache, by kernel",
    "device.compile.ms":
        "backend compile wall time per compilation, by kernel",
    "device.exec.calls": "profiled kernel dispatches, by kernel",
    "device.exec.ms": "per-call device wall time, by kernel",
    "device.xfer.h2d_bytes":
        "host-to-device bytes by upload site",
    "device.xfer.d2h_bytes":
        "device-to-host readback bytes by site",
    "flightrec.ring.events": "events journaled into the flight ring",
    "flightrec.dump.written": "postmortem bundles written",
    "flightrec.dump.errors": "postmortem bundle writes that failed",
    "controller.tick.count": "autotune controller evaluation ticks",
    "controller.decisions.applied":
        "enforced knob changes, by rule",
    "controller.decisions.shadowed":
        "decisions journaled without application (shadow mode), "
        "by rule",
    "controller.journal.dropped":
        "decision-journal entries dropped past the bound",
    "controller.knob.value":
        "current autotuned knob value, by knob",
    "serving.fleet.routed":
        "jobs and traversals dispatched by the fleet router, by "
        "replica instance",
    "serving.fleet.redispatches":
        "in-flight jobs re-dispatched to a survivor after their "
        "replica died (idempotent failover)",
    "serving.fleet.redispatch_latency_ms":
        "death-detection to survivor-accept wall time per failover",
    "serving.fleet.replicas_up":
        "replicas currently routable (healthy and un-evicted)",
    "scan.remote.splits_dispatched":
        "scan splits shipped to HTTP scan workers",
    "scan.remote.splits_merged":
        "scan splits whose results merged successfully",
    "scan.remote.splits_redispatched":
        "scan splits re-queued after a worker failure",
    "scan.remote.worker_failures":
        "scan-worker retirements, by worker url",
    "scan.remote.splits_served":
        "splits executed on this scan-worker node",
    "obs.ingest.spans":
        "remote spans spliced into local traces (Tracer.ingest)",
    "obs.ingest.dropped":
        "remote spans dropped by the per-call ingest bound, remote "
        "ring drops included",
    "obs.ingest.clamped":
        "ingested spans whose timestamps were clamped into the "
        "coordinator's send/receive window",
    "obs.federate.scrapes": "federation scrape attempts, all peers",
    "obs.federate.errors":
        "failed federation scrapes, by peer instance",
    "obs.federate.evicted":
        "peers evicted from the federated exposition after "
        "consecutive scrape failures",
    "obs.federate.series_dropped":
        "peer samples dropped by the per-peer series cap",
}

_ILLEGAL = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_ILLEGAL = re.compile(r"[^a-zA-Z0-9_]")


def sanitize(name: str) -> str:
    """Metric name → Prometheus grammar ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = _ILLEGAL.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _esc(value: str) -> str:
    """Label value escaping per the exposition spec."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(labels: dict, extra: str = "") -> str:
    """``{k="v",...}`` with sorted keys; ``extra`` (a pre-rendered pair
    like the summary ``quantile``) lands last, per convention."""
    pairs = [f'{_LABEL_ILLEGAL.sub("_", str(k))}="{_esc(v)}"'
             for k, v in sorted(labels.items())]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _num(v: float) -> str:
    """Sample value formatting: integers stay integral, floats use
    repr-precision (Prometheus parses both)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _help_line(name: str, sanitized: str) -> list:
    text = HELP.get(name)
    return [f"# HELP {sanitized} {text}"] if text else []


def render_prometheus(manager: MetricManager) -> str:
    """One scrape body for every metric in ``manager`` (trailing
    newline included, as the exposition format requires)."""
    lines: list[str] = []
    labeled = manager.labeled()
    gauge_counters = manager.gauge_counters()
    for name, val in manager.snapshot().items():
        kind = val.get("type")
        kids = labeled.get(name, ())
        if kind == "counter":
            n = sanitize(name)
            ptype = "gauge" if name in gauge_counters else "counter"
            lines += _help_line(name, n)
            lines.append(f"# TYPE {n} {ptype}")
            lines.append(f"{n} {_num(val['count'])}")
            for lbls, st in kids:
                lines.append(f"{n}{_labels(lbls)} {_num(st['count'])}")
        elif kind == "timer":
            n = sanitize(name) + "_seconds"
            lines += _help_line(name, n)
            lines.append(f"# TYPE {n} summary")
            lines.append(f"{n}_count {_num(val['count'])}")
            lines.append(f"{n}_sum {_num(val['total_ms'] / 1e3)}")
            for lbls, st in kids:
                ls = _labels(lbls)
                lines.append(f"{n}_count{ls} {_num(st['count'])}")
                lines.append(f"{n}_sum{ls} {_num(st['total_ms'] / 1e3)}")
            lines.append(f"# TYPE {n}_max gauge")
            lines.append(f"{n}_max {_num(val['max_ms'] / 1e3)}")
        elif kind == "histogram":
            n = sanitize(name)
            lines += _help_line(name, n)
            lines.append(f"# TYPE {n} summary")
            lines.append(f'{n}{{quantile="0.5"}} {_num(val["p50"])}')
            lines.append(f'{n}{{quantile="0.95"}} {_num(val["p95"])}')
            lines.append(f"{n}_count {_num(val['count'])}")
            lines.append(f"{n}_sum {_num(val['total'])}")
            for lbls, st in kids:
                q50 = _labels(lbls, 'quantile="0.5"')
                q95 = _labels(lbls, 'quantile="0.95"')
                ls = _labels(lbls)
                lines.append(f"{n}{q50} {_num(st['p50'])}")
                lines.append(f"{n}{q95} {_num(st['p95'])}")
                lines.append(f"{n}_count{ls} {_num(st['count'])}")
                lines.append(f"{n}_sum{ls} {_num(st['total'])}")
    for name, g in manager.gauge_snapshot().items():
        n = sanitize(name)
        lines += _help_line(name, n)
        lines.append(f"# TYPE {n} gauge")
        if g["own"] or not g["children"]:
            # a children-only parent's value is the sum roll-up —
            # additive families read fine programmatically, but a
            # ratio family (burn rates) must not export a fabricated
            # unlabeled sample
            lines.append(f"{n} {_num(g['value'])}")
        for lbls, v in g["children"]:
            lines.append(f"{n}{_labels(lbls)} {_num(v)}")
    return "\n".join(lines) + "\n" if lines else "\n"
