"""The port's deployment assembly (titan_tpu_torch.deploy) against the JAX
package's titan_tpu.deploy: the same services spawn the port's modules
with the JAX package's arguments, pidfiles and status read alike, and a
kind under the JAX package or JAX is refused before anything spawns.
Tier-1 spawns nothing (``subprocess.Popen`` and ``os.kill`` are faked);
the real lifecycle is marked ``slow``, as tests/test_deploy.py's is, and
runs on the card's host in chip_smoke.py phase 18."""

import importlib.util
import os
import signal
import sys
import textwrap
import time

import pytest

import titan_tpu.deploy as JD
import titan_tpu_torch.deploy as PD

#: the directory that holds titan_tpu_torch, first on a service's path
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(PD.__file__)))

SERVICES = [{"kind": "storage-node", "data-dir": "/d/a", "port": 1},
            {"kind": "index-node", "data-dir": "/d/b", "port": 2,
             "host": "127.0.0.1"},
            {"kind": "scan-worker", "port": 3},
            {"kind": "graph-server", "conf": "server.yaml"},
            {"kind": "storage-node"}, {"kind": "scan-worker"}]


@pytest.mark.parametrize("svc", SERVICES, ids=lambda s: s["kind"])
def test_service_commands_are_the_port_s_modules(svc):
    want = [a.replace("titan_tpu.", "titan_tpu_torch.")
            if a.startswith("titan_tpu.") else a
            for a in JD._KINDS[svc["kind"]](svc)]
    got = PD._KINDS[svc["kind"]](svc)
    assert got == want and got[:2] == [sys.executable, "-m"]
    assert got[2].startswith("titan_tpu_torch.")
    assert importlib.util.find_spec(got[2]) is not None
    assert set(PD._KINDS) == set(JD._KINDS)


def _write(tmp_path, body: str, name="dep.yaml"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


def test_load_names_and_pid_dir(tmp_path):
    path = _write(tmp_path, """\
        services:
          - kind: storage-node
            name: store-a
          - kind: scan-worker
        """)
    for mod in (JD, PD):
        cfg, pid_dir = mod._load(path)
        assert pid_dir == str(tmp_path / ".pids")
        assert [mod._name(i, s) for i, s in
                enumerate(cfg["services"])] == ["store-a", "scan-worker-1"]
    path = _write(tmp_path, f"pid-dir: {tmp_path}/run\nservices: []\n",
                  "b.yaml")
    assert PD._load(path) == JD._load(path) == (
        {"pid-dir": f"{tmp_path}/run", "services": []}, f"{tmp_path}/run")
    assert PD._pidfile("/r", "x") == JD._pidfile("/r", "x") == "/r/x.pid"


@pytest.mark.parametrize("kind", ["titan_tpu.storage.remote",
                                  "jax.numpy", "jaxlib.xla_client"])
def test_a_foreign_kind_is_refused_before_anything_spawns(tmp_path, kind,
                                                          monkeypatch):
    path = _write(tmp_path, f"services:\n  - kind: {kind}\n")
    monkeypatch.setattr(PD.subprocess, "Popen", _no_spawn)
    for call in (PD.start, PD.status, PD.stop):
        with pytest.raises(ValueError, match="titan_tpu_torch never"):
            call(path)
    assert not os.path.exists(tmp_path / ".pids")


def _no_spawn(*a, **kw):
    raise AssertionError("spawned a process")


def test_an_unknown_kind_exits_like_jax(tmp_path, monkeypatch):
    path = _write(tmp_path, "services:\n  - kind: nope\n")
    monkeypatch.setattr(PD.subprocess, "Popen", _no_spawn)
    monkeypatch.setattr(JD.subprocess, "Popen", _no_spawn)
    msgs = []
    for mod in (JD, PD):
        with pytest.raises(SystemExit) as e:
            mod.start(path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "unknown service kind 'nope' (nope-0)"


class _Procs:
    """Fake processes: ``Popen`` hands out pids no real process has, and
    ``os.kill`` answers for them (SIGTERM ends one); any other pid goes
    to the real ``os.kill``."""

    def __init__(self, monkeypatch):
        self.alive, self.argv, self.signals = set(), [], []
        self.next_pid = 4_000_000
        self.real_kill = os.kill
        monkeypatch.setattr(PD.subprocess, "Popen", self.popen)
        monkeypatch.setattr(os, "kill", self.kill)

    def popen(self, argv, **kw):
        assert kw["start_new_session"] and kw["stderr"] is not None
        assert kw["env"]["PYTHONPATH"].split(os.pathsep)[0] == ROOT
        self.next_pid += 1
        self.alive.add(self.next_pid)
        self.argv.append(argv)
        return type("P", (), {"pid": self.next_pid})()

    def kill(self, pid, sig):
        if pid < 4_000_000:
            return self.real_kill(pid, sig)
        if pid not in self.alive:
            raise ProcessLookupError(pid)
        self.signals.append((pid, sig))
        if sig in (signal.SIGTERM, signal.SIGKILL):
            self.alive.discard(pid)


def test_start_status_stop_over_pidfiles(tmp_path, monkeypatch, capsys):
    procs = _Procs(monkeypatch)
    path = _write(tmp_path, f"""\
        services:
          - kind: storage-node
            name: store-a
            data-dir: {tmp_path}/store-a
            port: 18233
          - kind: scan-worker
            name: worker-a
            port: 0
        """)
    assert PD.start(path) == 2
    pids = sorted(procs.alive)
    assert [a[2] for a in procs.argv] == ["titan_tpu_torch.storage.remote",
                                          "titan_tpu_torch.olap.scan_worker"]
    pid_dir = tmp_path / ".pids"
    assert sorted(int((pid_dir / f"{n}.pid").read_text())
                  for n in ("store-a", "worker-a")) == pids
    assert (pid_dir / "store-a.log").exists()
    assert PD.status(path) == {"store-a": pids[0], "worker-a": pids[1]}
    assert PD.start(path) == 0                  # idempotent
    assert PD.stop(path) == 2
    assert procs.alive == set()
    assert [s for _, s in procs.signals if s] == [signal.SIGTERM] * 2
    assert PD.status(path) == {"store-a": None, "worker-a": None}
    assert not (pid_dir / "store-a.pid").exists()
    assert PD.stop(path) == 0
    out = capsys.readouterr().out
    assert "store-a: started (pid" in out and "worker-a: stopped" in out
    assert "store-a: not running" in out


def test_a_stale_or_garbled_pidfile_reads_as_stopped(tmp_path):
    path = _write(tmp_path, "services:\n  - kind: scan-worker\n")
    pid_dir = tmp_path / ".pids"
    pid_dir.mkdir()
    (pid_dir / "scan-worker-0.pid").write_text("not a pid")
    assert PD.status(path) == JD.status(path) == {"scan-worker-0": None}
    (pid_dir / "scan-worker-0.pid").write_text(str(2**22 + 12345))
    assert PD.status(path) == {"scan-worker-0": None}
    (pid_dir / "scan-worker-0.pid").write_text(str(os.getpid()))
    assert PD.status(path) == {"scan-worker-0": os.getpid()}


def test_main_usage(tmp_path, capsys):
    for argv in ([], ["start"], ["restart", "x.yaml"]):
        with pytest.raises(SystemExit) as e:
            PD.main(argv)
        assert e.value.code == 2
    assert "python -m titan_tpu_torch.deploy" in capsys.readouterr().err
    path = _write(tmp_path, "services: []\n")
    PD.main(["status", path])


@pytest.mark.slow
def test_deploy_lifecycle(tmp_path):
    """tests/test_deploy.py's lifecycle on the port: real processes."""
    path = _write(tmp_path, f"""\
        services:
          - kind: storage-node
            name: store-a
            data-dir: {tmp_path}/store-a
            port: 0
          - kind: scan-worker
            name: worker-a
            port: 0
        """)
    assert PD.start(path) == 2
    time.sleep(1.0)
    st = PD.status(path)
    assert st["store-a"] and st["worker-a"]
    assert PD.start(path) == 0
    assert PD.stop(path) == 2
    st = PD.status(path)
    assert st["store-a"] is None and st["worker-a"] is None
    assert os.path.exists(str(tmp_path / ".pids" / "store-a.log"))


@pytest.mark.slow
def test_an_exited_child_reads_as_stopped_unlike_jax(tmp_path):
    """ROADMAP queue 3 item 16, pinned for both packages: a service this
    process started that has exited is a zombie until reaped, and answers
    kill(pid, 0). The JAX package's status reports it running and its
    stop waits 5 s before a SIGKILL; the port reaps it and reads it as
    stopped."""
    got = {}
    for name, mod in (("jax", JD), ("port", PD)):
        path = _write(tmp_path, f"""\
            pid-dir: {tmp_path}/{name}
            services:
              - kind: scan-worker
                name: worker-a
                port: 0
            """, f"{name}.yaml")
        assert mod.start(path) == 1
        time.sleep(1.0)
        pid = mod.status(path)["worker-a"]
        os.kill(pid, signal.SIGTERM)
        time.sleep(1.0)
        seen = mod.status(path)["worker-a"]
        t0 = time.time()
        mod.stop(path)
        got[name] = (seen, time.time() - t0)
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass
    assert got["jax"][0] is not None and got["jax"][1] >= 4.5
    assert got["port"][0] is None and got["port"][1] < 1.0
