"""The port's replica fleet (``titan_tpu_torch/olap/fleet/``) against the
JAX package's: the routing policy over the same synthetic replicas picks
alike, and a live fleet of the port's replicas (on the CPU) over one
``remote`` storage node admits, counts once, fails over under an
unchanged idempotency key and adopts checkpoints as
``tests/test_fleet.py`` holds JAX's to."""

import json
import time

import numpy as np
import pytest

import titan_tpu_torch
from titan_tpu.olap import fleet as jfleet
from titan_tpu.utils.metrics import MetricManager as JM
from titan_tpu_torch.errors import TemporaryBackendError
from titan_tpu_torch.olap import fleet as pfleet
from titan_tpu_torch.olap.api import JobSpec
from titan_tpu_torch.olap.fleet.replica import build
from titan_tpu_torch.olap.serving.scheduler import JobScheduler
from titan_tpu_torch.storage.inmemory import InMemoryStoreManager
from titan_tpu_torch.storage.remote import KCVSServer
from titan_tpu_torch.utils.httpnode import json_call, text_get
from titan_tpu_torch.utils.metrics import MetricManager as PM

#: per package: (fleet package, MetricManager)
PKGS = {"jax": (jfleet, JM), "port": (pfleet, PM)}


def _expo(depth: float, hbm: float) -> str:
    return (f"# TYPE serving_queue_depth counter\n"
            f"serving_queue_depth {depth}\n"
            f"# TYPE serving_hbm_resident_bytes gauge\n"
            f"serving_hbm_resident_bytes {hbm}\n")


class _FakeFleet:
    """Injectable fetch over synthetic replicas: ``rows`` maps url ->
    {"depth", "hbm", "lag"}; urls in ``dead`` raise."""

    def __init__(self, rows):
        self.rows = rows
        self.dead = set()

    def __call__(self, url, path):
        if url in self.dead:
            raise OSError("connection refused")
        row = self.rows[url]
        path = path.split("?", 1)[0]
        if path == "/metrics":
            return _expo(row.get("depth", 0), row.get("hbm", 0))
        if path == "/healthz":
            return json.dumps({"live": True, "ready": True})
        if path == "/live":
            return json.dumps(
                {"enabled": True,
                 "freshness": {"lag_epochs": row.get("lag", 0)}})
        raise ValueError(path)


def _routers(rows, names=("r1", "r2"), **kw):
    """One router of each package over the same fake fleet, replicas
    added under ``names`` and scraped once."""
    fake = _FakeFleet(rows)
    out = {}
    for which, (fleet, M) in PKGS.items():
        kw.setdefault("autotune", "off")
        r = fleet.FleetRouter(fetch=fake, autopump=False, metrics=M(), **kw)
        for url, name in zip(rows, names):
            r.add_replica(url, instance=name)
        r.membership.scrape()
        out[which] = r
    return fake, out


def _alike(routers, call):
    got = {w: call(r) for w, r in routers.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def test_membership_signals_parse_alike():
    fake, routers = _routers({"http://r1": {"depth": 3, "hbm": 1e6,
                                            "lag": 2},
                              "http://r2": {"depth": 0, "hbm": 0}})
    sig = _alike(routers, lambda r: r.membership.signals())
    assert sig["r1"] == {"up": True, "url": "http://r1", "queue_depth": 3.0,
                         "hbm_resident_bytes": 1e6, "lag_epochs": 2.0}
    assert sig["r2"]["lag_epochs"] == 0.0


def test_membership_eviction_and_unevict_alike():
    fake, routers = _routers({"http://r1": {}, "http://r2": {}},
                             max_failures=3)
    fake.dead.add("http://r1")
    views = []
    for _ in range(3):
        _alike(routers, lambda r: r.membership.scrape())
        views.append(_alike(routers, lambda r: (
            r.membership.signals()["r1"]["up"],
            r.membership.fleet()["peers"][0]["evicted"])))
    assert views == [(False, False), (False, False), (False, True)]
    fake.dead.clear()
    _alike(routers, lambda r: r.membership.scrape())
    assert _alike(routers, lambda r: r.membership.signals()["r1"]["up"])


@pytest.mark.parametrize("rows,names,exclude,want", [
    ({"http://r1": {"depth": 8, "hbm": 4e8},
      "http://r2": {"depth": 2, "hbm": 5e8}}, ("r1", "r2"), (), "r2"),
    ({"http://r1": {"depth": 8, "hbm": 4e8},
      "http://r2": {"depth": 2, "hbm": 5e8}}, ("r1", "r2"), ("r2",), "r1"),
    ({"http://r1": {"depth": 1}, "http://r2": {"depth": 1}}, ("b", "a"),
     (), "a"),
    ({"http://r1": {"depth": 0, "lag": 9}, "http://r2": {"depth": 0.5}},
     ("r1", "r2"), (), "r2"),
    ({"http://r1": {"depth": 0}}, ("r1",), ("r1",), None),
])
def test_pick_is_the_same(rows, names, exclude, want):
    _, routers = _routers(rows, names)
    got = _alike(routers, lambda r: r._pick(exclude=set(exclude)))
    assert (got[0] if got else None) == want


def test_weights_move_the_pick_only_when_enforced():
    rows = {"http://r1": {"depth": 8, "hbm": 4e8},
            "http://r2": {"depth": 2, "hbm": 5e8}}
    for mode, want in (("enforce", "r1"), ("shadow", "r2")):
        _, routers = _routers(rows, autotune=mode)
        for r in routers.values():
            r.controller.fleet_weights["hbm"] = 100.0
        assert _alike(routers, lambda r: r._pick()[0]) == want
        assert _alike(routers, lambda r: r._weights()["hbm"]) == \
            (100.0 if mode == "enforce" else 1.0)


def test_down_replicas_leave_the_pick_and_submit_refuses():
    fake, routers = _routers({"http://r1": {"depth": 0},
                              "http://r2": {"depth": 9}})
    fake.dead.add("http://r1")
    _alike(routers, lambda r: r.membership.scrape())
    assert _alike(routers, lambda r: r._pick()[0]) == "r2"
    fake.dead.add("http://r2")
    _alike(routers, lambda r: r.membership.scrape())
    assert _alike(routers, lambda r: r._pick()) is None
    with pytest.raises(TemporaryBackendError, match="no replica"):
        routers["port"]._submit({"kind": "bfs", "source": 0})
    assert routers["port"]._metrics.counter_value(
        "serving.jobs.submitted") == 0


def test_fleet_signals_depth_spread_feeds_the_controller_alike():
    from titan_tpu_torch.olap.serving.autotune import evaluate
    _, routers = _routers({"http://r1": {}, "http://r2": {}},
                          autotune="enforce")
    for r in routers.values():
        r._inflight = {"r1": 8, "r2": 0}
    sig = _alike(routers, lambda r: {k: v for k, v in
                                     r._fleet_signals().items() if k != "t"})
    assert sig["fleet"]["depth_spread"] == 2.0
    sig["knobs"] = {"fleet_weights": {}}
    props = evaluate(sig, sig["knobs"], routers["port"].controller.params)
    assert [p["rule"] for p in props] == ["fleet.rebalance"]
    assert props[0]["knob"] == "fleet.routing_weight.depth"


# -- a live fleet of the port's replicas over one remote storage node --------

_TERMINAL = ("done", "failed", "timeout", "cancelled", "expired")


@pytest.fixture(scope="module")
def shared_store():
    """A port storage node holding a 40-vertex chain, mounted through
    ``storage.backend: remote``."""
    storage = KCVSServer(InMemoryStoreManager()).start()
    gcfg = {"storage.backend": "remote", "storage.hostname": "127.0.0.1",
            "storage.port": storage.port, "storage.lock.wait-time": 5,
            "ids.authority.wait-time": 5}
    loader = titan_tpu_torch.open(dict(gcfg))
    tx = loader.new_transaction()
    vs = [tx.add_vertex() for _ in range(40)]
    for a in range(39):
        tx.add_edge(vs[a], "knows", vs[a + 1])
    tx.commit()
    yield gcfg, [v.id for v in vs]
    loader.close()
    storage.stop()


def _replica(gcfg, ck, **sched):
    g, s, srv = build({"graph": gcfg, "checkpoint_dir": ck,
                       "scheduler": {"device": "cpu", **sched}})
    assert s.device.type == "cpu"
    return g, s, srv.start()


def _url(srv) -> str:
    return f"http://{srv.host}:{srv.port}"


def _stop(reps):
    for g, sched, srv in reps:
        try:
            sched.close(timeout=30)
        except Exception:   # noqa: BLE001 — teardown
            pass
        srv.stop()
        g.close()


def _drive(router, jid, deadline_s=60.0):
    w = None
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        router.pump()
        w = json.loads(text_get(router.url, f"/jobs/{jid}"))
        if w["state"] in _TERMINAL:
            return w
        time.sleep(0.02)
    return w


def test_router_routes_a_mixed_stream_and_counts_once(shared_store,
                                                      tmp_path):
    """BFS, PageRank and WCC through the router over two port replicas,
    each result equal to the direct call on a snapshot of the same graph;
    submitted counted once a job; the surfaces answer. (SSSP rides the
    fleet on the card, in chip_smoke.py's phase 16: on this chain its
    stalled rounds escalate to [8, 2^23] pushes, seconds a round in the
    plain CPU path.)"""
    from titan_tpu_torch.models.bfs_hybrid import frontier_bfs_batched
    from titan_tpu_torch.models.frontier import pagerank_dense, frontier_wcc
    from titan_tpu_torch.olap import snapshot as snap_mod
    gcfg, ids = shared_store
    reps = [_replica(gcfg, str(tmp_path)) for _ in range(2)]
    # the router names a replica host:port
    sched_of = {f"{srv.host}:{srv.port}": s for _, s, srv in reps}
    m = PM()
    router = pfleet.FleetRouter([_url(srv) for _, _, srv in reps], metrics=m,
                                autotune="off", autopump=False).start()
    ref_g = titan_tpu_torch.open(dict(gcfg))
    try:
        bodies = ([{"kind": "bfs", "source": ids[i], "targets": [ids[-1]]}
                   for i in (0, 5)]
                  + [{"kind": "pagerank", "iterations": 5},
                     {"kind": "wcc"}])
        outs = [json_call(router.url, "/jobs", b) for b in bodies]
        finals = [_drive(router, o["job"]) for o in outs]
        snap = snap_mod.build(ref_g, directed=False)
        dist, levels, _ = frontier_bfs_batched(
            snap, [snap.dense_of(ids[0]), snap.dense_of(ids[5])],
            device="cpu")
        for w, row, lv, src in zip(finals[:2], dist, levels, (0, 5)):
            assert w["state"] == "done", w
            assert w["remote"]["result"]["targets"] == {str(ids[-1]):
                                                        39 - src}
            assert w["remote"]["result"]["levels"] == int(lv)
            np.testing.assert_array_equal(sched_of[w["replica"]].get(
                w["remote_job"]).result["dist"], row)
        rank, _ = pagerank_dense(snap, iterations=5, device="cpu")
        labels, _ = frontier_wcc(snap, device="cpu")
        for w, key, want in ((finals[2], "rank", rank),
                             (finals[3], "labels", labels)):
            assert w["state"] == "done", w
            np.testing.assert_array_equal(sched_of[w["replica"]].get(
                w["remote_job"]).result[key], np.asarray(want))
        assert finals[3]["remote"]["result"]["components"] == 1
        assert m.counter_value("serving.jobs.submitted") == 4
        assert m.counter_value("serving.jobs.submitted",
                               labels={"kind": "bfs"}) == 2
        assert m.counter_value("serving.fleet.routed") == 4
        assert m.counter_value("serving.fleet.redispatches") == 0
        fl = json.loads(text_get(router.url, "/fleet"))
        assert fl["up"] == 2 and fl["down"] == 0
        assert sum(c.count for _, c in m.children(
            "serving.fleet.routed")) == 4
        hz = json.loads(text_get(router.url, "/healthz"))
        assert hz["ready"] and hz["replicas_up"] == 2
        body = text_get(router.url, "/metrics?federate=1")
        assert 'instance="' in body and "serving_fleet_replicas_up 2" in body
        tv = json_call(router.url, "/traverse", {
            "start": [ids[0]], "dir": "out", "hops": 2, "terminal": "id"})
        assert tv["result"] == [ids[2]] and tv["fallback"] is False
        assert m.counter_value("serving.fleet.routed") == 5
        tr = json.loads(text_get(router.url, f"/trace?job={outs[0]['job']}"))
        assert tr["spans"][0]["name"] == "job"
    finally:
        router.stop()
        _stop(reps)
        ref_g.close()


def test_failover_redispatches_once_never_recounts_submit(shared_store,
                                                          tmp_path):
    """The victim replica's scheduler never starts, so the job is in
    flight when the victim stops; the router redispatches it to the
    survivor under the same idempotency key, once, and the job ends
    equal to the uninterrupted distance."""
    gcfg, ids = shared_store
    ck = str(tmp_path)
    victim = _replica(gcfg, ck, autostart=False)
    survivor = _replica(gcfg, ck)
    m = PM()
    router = pfleet.FleetRouter(metrics=m, autotune="off", autopump=False)
    router.add_replica(_url(victim[2]), instance="a-victim")
    router.add_replica(_url(survivor[2]), instance="b-survivor")
    router.start()
    try:
        out = json_call(router.url, "/jobs", {
            "kind": "bfs", "source": ids[0], "checkpoint_every": 1,
            "targets": [ids[-1]]})
        jid = out["job"]
        assert out["replica"] == "a-victim"
        for _ in range(2):
            router.pump()
        assert json.loads(text_get(router.url,
                                   f"/jobs/{jid}"))["state"] == "queued"
        victim[2].stop()
        w = _drive(router, jid)
        assert w["state"] == "done", w
        assert w["replica"] == "b-survivor" and w["attempts"] == 2
        assert w["remote"]["result"]["targets"] == {str(ids[-1]): 39}
        assert m.counter_value("serving.jobs.submitted") == 1
        assert m.counter_value("serving.fleet.redispatches") == 1
        assert m.histogram_stats(
            "serving.fleet.redispatch_latency_ms")["count"] == 1
        rows = {p["instance"]: p for p in json.loads(
            text_get(router.url, "/fleet"))["peers"]}
        assert not rows["a-victim"]["up"] and rows["b-survivor"]["up"]
        tr = json.loads(text_get(router.url, f"/trace?job={jid}"))

        def walk(node):
            yield node
            for c in node.get("children", []):
                yield from walk(c)
        spans = [s for root in tr["spans"] for s in walk(root)]
        disp = [s for s in spans if s["name"] == "dispatch"]
        assert len(disp) == 2
        assert sum(1 for s in disp
                   if (s.get("attrs") or {}).get("redispatched")) == 1
        assert [s for s in spans
                if (s.get("attrs") or {}).get("instance") == "a-victim"
                and (s.get("attrs") or {}).get("remote")]
    finally:
        router.stop()
        _stop([victim, survivor])


def test_idempotency_key_adopts_checkpoints_across_schedulers(
        shared_store, tmp_path):
    """A second scheduler over the shared checkpoint store resumes an
    idempotency-keyed job from the first's newest checkpoint on its first
    attempt, and ends equal to a clean run."""
    gcfg, ids = shared_store
    ck = str(tmp_path / "ck")
    spec = dict(kind="bfs", params={"source": ids[0], "targets": [ids[-1]]},
                checkpoint_every=1, idempotency_key="logical-1")
    graphs = [titan_tpu_torch.open(dict(gcfg)) for _ in range(3)]
    try:
        a = JobScheduler(graph=graphs[0], checkpoint_dir=ck, metrics=PM(),
                         device="cpu")
        ja = a.submit(JobSpec(**spec))
        deadline = time.time() + 30
        while (ja.checkpoint_round or 0) < 3 and time.time() < deadline:
            time.sleep(0.005)
        assert (ja.checkpoint_round or 0) >= 3
        a.close(timeout=60)
        mb = PM()
        b = JobScheduler(graph=graphs[1], checkpoint_dir=ck, metrics=mb,
                         device="cpu")
        try:
            jb = b.submit(JobSpec(**spec))
            assert jb.wait(60) and jb.state.value == "done", jb.error
            assert mb.counter_value("serving.recovery.resumes") == 1
            assert jb.rounds_replayed <= 39
            assert jb.result["targets"] == {str(ids[-1]): 39}
        finally:
            b.close()
        c = JobScheduler(graph=graphs[2], checkpoint_dir=str(tmp_path / "c"),
                         metrics=PM(), device="cpu")
        try:
            jc = c.submit(JobSpec(kind="bfs", params={
                "source": ids[0], "targets": [ids[-1]]}))
            assert jc.wait(60) and jc.state.value == "done", jc.error
            np.testing.assert_array_equal(jc.result["dist"],
                                          jb.result["dist"])
        finally:
            c.close()
    finally:
        for g in graphs:
            g.close()


def test_replica_cli_needs_a_config(capsys):
    from titan_tpu_torch.olap.fleet import replica
    with pytest.raises(SystemExit) as exc:
        replica.main([])
    assert exc.value.code == 2
    assert "titan_tpu_torch.olap.fleet.replica" in capsys.readouterr().err
