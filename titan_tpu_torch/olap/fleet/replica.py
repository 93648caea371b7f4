"""Replica serving process: one full GraphServer + JobScheduler.

The fleet's unit of capacity (docs/fleet.md): ``python -m
titan_tpu_torch.olap.fleet.replica '<json config>'`` opens the SHARED graph
storage, builds a :class:`~titan_tpu_torch.olap.serving.scheduler.
JobScheduler` over it and serves the whole GraphServer surface —
``/jobs``, ``/traverse``, ``/metrics``, ``/healthz``, ``/live``,
``/trace/export`` — on its own port. The router never speaks anything a
plain replica doesn't already serve, so a replica is independently
debuggable with curl.

Config keys (JSON object on argv[1], or ``-`` to read stdin):

``graph``
    the ``titan_tpu_torch.open`` config dict — MUST point at the same
    storage backend on every replica (shared store = shared epochs =
    adoptable checkpoints);
``checkpoint_dir``
    SHARED checkpoint directory. Failover depends on it: a redispatched
    job's idempotency key resolves to the same ``idem-<key>`` record
    from any replica, so the survivor resumes from the dead replica's
    newest checkpoint instead of restarting (olap/recovery);
``host`` / ``port``
    bind address (default 127.0.0.1:0 — the banner prints the real
    port); ``instance`` names the replica in federated metrics;
``auth_token``
    optional bearer token (else TITAN_TPU_NODE_TOKEN applies);
``scheduler``
    optional kwargs forwarded to the JobScheduler ctor (quotas,
    autotune mode, checkpoint cadence...).
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Optional


def build(config: dict):
    """Build (graph, scheduler, server) from one replica config —
    importable seam so tests and bench can run an in-process replica
    from the exact config the process entry uses."""
    import titan_tpu_torch
    from titan_tpu_torch.olap.serving.scheduler import JobScheduler
    from titan_tpu_torch.server import GraphServer

    graph = titan_tpu_torch.open(dict(config["graph"]))
    sched_kw = dict(config.get("scheduler") or {})
    if config.get("checkpoint_dir"):
        sched_kw.setdefault("checkpoint_dir", config["checkpoint_dir"])
    scheduler = JobScheduler(graph=graph, **sched_kw)
    server = GraphServer(
        graph, host=config.get("host", "127.0.0.1"),
        port=int(config.get("port", 0)),
        auth_token=config.get("auth_token"),
        scheduler=scheduler)
    return graph, scheduler, server


def main(argv: Optional[list] = None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: python -m titan_tpu_torch.olap.fleet.replica "
              "'<json config>' (or - for stdin)", file=sys.stderr)
        raise SystemExit(2)
    raw = sys.stdin.read() if args[0] == "-" else args[0]
    config = json.loads(raw)
    graph, scheduler, server = build(config)
    server.start()
    host = config.get("host", "127.0.0.1")
    if host not in ("127.0.0.1", "localhost") \
            and server.auth_token is None:
        print("WARNING: replica bound to a non-local interface with no "
              "auth token set — any peer can submit jobs",
              file=sys.stderr)
    # the exact banner the fleet smoke + router tooling parse for the
    # bound port (mirrors scan_worker's)
    print(f"replica serving on http://{server.host}:{server.port}",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        scheduler.close()
        server.stop()


if __name__ == "__main__":
    main()
