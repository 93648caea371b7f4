"""Deployment assembly: start/stop/status for a whole node set.

(reference: titan-dist/src/assembly/static — ``titan.sh`` boots the
storage backend, the index backend, and Gremlin Server as one unit with
pidfiles; here ``python -m titan_tpu_torch.deploy <cmd> <deployment.yaml>``
does the same for this framework's services. The port's copy of
``titan_tpu/deploy.py``: the services it spawns are the port's.)

Deployment file shape (docs/config-reference.md documents graph options)::

    pid-dir: /var/run/titan-tpu        # default: <yaml-dir>/.pids
    services:
      - kind: storage-node             # python -m titan_tpu_torch.storage.remote
        data-dir: /data/store-a
        port: 8283
      - kind: index-node               # python -m titan_tpu_torch.indexing.remote
        data-dir: /data/index-a
        port: 8304
      - kind: scan-worker              # python -m titan_tpu_torch.olap.scan_worker
        port: 8391
      - kind: graph-server             # python -m titan_tpu_torch.server
        conf: server.yaml              # gremlin-server.yaml analog

Commands: ``start`` (spawns anything not already running), ``stop``
(SIGTERM by pidfile), ``status``. A ``kind`` that names a module under the
JAX package or JAX (``titan_tpu.storage.remote``, say) raises
``ValueError`` before anything is spawned (``errors.refuse_foreign``);
any other unknown kind exits as the JAX package's does.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Optional

from titan_tpu_torch.errors import refuse_foreign

_KINDS = {
    "storage-node": lambda s: [sys.executable, "-m",
                               "titan_tpu_torch.storage.remote",
                               s.get("data-dir", "."),
                               str(s.get("port", 8283)),
                               s.get("host", "0.0.0.0")],
    "index-node": lambda s: [sys.executable, "-m",
                             "titan_tpu_torch.indexing.remote",
                             s.get("data-dir", "."),
                             str(s.get("port", 8304)),
                             s.get("host", "0.0.0.0")],
    # scan workers execute shipped job factories — localhost unless the
    # deployment explicitly opts into a wider bind (pair with
    # TITAN_TPU_NODE_TOKEN in the service env)
    "scan-worker": lambda s: [sys.executable, "-m",
                              "titan_tpu_torch.olap.scan_worker",
                              str(s.get("port", 8391)),
                              s.get("host", "127.0.0.1")],
    "graph-server": lambda s: [sys.executable, "-m",
                               "titan_tpu_torch.server", s["conf"]],
}


def _load(path: str) -> tuple[dict, str]:
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    for i, svc in enumerate(cfg.get("services") or ()):
        kind = svc.get("kind")
        if isinstance(kind, str):
            refuse_foreign(kind, f"service {_name(i, svc)!r} kind")
    pid_dir = cfg.get("pid-dir") or os.path.join(
        os.path.dirname(os.path.abspath(path)), ".pids")
    return cfg, pid_dir


def _name(i: int, svc: dict) -> str:
    return svc.get("name") or f"{svc['kind']}-{i}"


def _pidfile(pid_dir: str, name: str) -> str:
    return os.path.join(pid_dir, name + ".pid")


def _running(pidfile: str) -> Optional[int]:
    try:
        with open(pidfile) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return None
    try:
        # a service this process spawned stays a zombie after it exits
        # until it is reaped, and a zombie still answers kill(pid, 0):
        # reap it here so it reads as stopped (the JAX package's status
        # reports it running and its stop waits 5 s, then SIGKILLs it;
        # ROADMAP queue 3, item 16)
        if os.waitpid(pid, os.WNOHANG)[0] == pid:
            return None
    except ChildProcessError:
        pass                             # not a child of this process
    try:
        os.kill(pid, 0)
    except PermissionError:
        return pid   # exists, owned by another user (e.g. root-started)
    except OSError:
        return None
    return pid


def _service_env() -> dict:
    """This process's environment, with the directory that holds this
    ``titan_tpu_torch`` first on ``PYTHONPATH``: a service runs in the
    deployment file's directory and imports the deployer's own package,
    installed or not."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def start(path: str) -> int:
    cfg, pid_dir = _load(path)
    os.makedirs(pid_dir, exist_ok=True)
    started = 0
    for i, svc in enumerate(cfg.get("services", ())):
        name = _name(i, svc)
        pf = _pidfile(pid_dir, name)
        if _running(pf):
            print(f"{name}: already running")
            continue
        kind = svc.get("kind")
        if kind not in _KINDS:
            raise SystemExit(f"unknown service kind {kind!r} ({name})")
        logf = open(os.path.join(pid_dir, name + ".log"), "ab")
        proc = subprocess.Popen(
            _KINDS[kind](svc), stdout=logf, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(path)) or ".",
            env=_service_env(), start_new_session=True)
        with open(pf, "w") as f:
            f.write(str(proc.pid))
        print(f"{name}: started (pid {proc.pid})")
        started += 1
    return started


def stop(path: str) -> int:
    cfg, pid_dir = _load(path)
    stopped = 0
    for i, svc in enumerate(cfg.get("services", ())):
        name = _name(i, svc)
        pf = _pidfile(pid_dir, name)
        pid = _running(pf)
        if pid is None:
            print(f"{name}: not running")
            continue
        os.kill(pid, signal.SIGTERM)
        for _ in range(50):
            if _running(pf) is None:
                break
            time.sleep(0.1)
        else:
            os.kill(pid, signal.SIGKILL)
        try:
            os.remove(pf)
        except OSError:
            pass
        print(f"{name}: stopped")
        stopped += 1
    return stopped


def status(path: str) -> dict:
    cfg, pid_dir = _load(path)
    out = {}
    for i, svc in enumerate(cfg.get("services", ())):
        name = _name(i, svc)
        pid = _running(_pidfile(pid_dir, name))
        out[name] = pid
        print(f"{name}: {'running (pid %d)' % pid if pid else 'stopped'}")
    return out


def main(argv: Optional[list] = None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) != 2 or args[0] not in ("start", "stop", "status"):
        print("usage: python -m titan_tpu_torch.deploy start|stop|status "
              "<deployment.yaml>", file=sys.stderr)
        raise SystemExit(2)
    {"start": start, "stop": stop, "status": status}[args[0]](args[1])


if __name__ == "__main__":
    main()
