"""The port's HTTP front door (``titan_tpu_torch/server.py``) against the
JAX package's ``GraphServer``: the same requests on twin graphs of the
gods (``tests/torch_twins.py``), one server of each package, the port's
scheduler on the CPU, every status and body held to JAX's after the
normalizations named in ``VOLATILE`` and ``_norm``."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from titan_tpu import errors as jerr
from titan_tpu import server as jserver
from titan_tpu.obs.slo import SLO as JSLO
from titan_tpu.olap.api import JobSpec as JSpec
from titan_tpu.olap.recovery import FaultPlan as JFault
from titan_tpu.olap.serving import tenants as jten
from titan_tpu.olap.serving.scheduler import JobScheduler as JJ
from titan_tpu.utils.metrics import MetricManager as JM
from titan_tpu_torch import errors as perr
from titan_tpu_torch import server as pserver
from titan_tpu_torch.obs.promexport import CONTENT_TYPE
from titan_tpu_torch.obs.slo import SLO as PSLO
from titan_tpu_torch.olap.api import JobSpec as PSpec
from titan_tpu_torch.olap.recovery import FaultPlan as PFault
from titan_tpu_torch.olap.serving import tenants as pten
from titan_tpu_torch.olap.serving.scheduler import JobScheduler as PJ
from titan_tpu_torch.utils.metrics import MetricManager as PM
from torch_twins import PKGS as TWINS
from torch_twins import open_twin

#: per package: (server module, JobScheduler, MetricManager, errors,
#: tenants, SLO, JobSpec, FaultPlan, scheduler keywords)
PKGS = {"jax": (jserver, JJ, JM, jerr, jten, JSLO, JSpec, JFault, {}),
        "port": (pserver, PJ, PM, perr, pten, PSLO, PSpec, PFault,
                 {"device": "cpu"})}

#: what differs between the packages for the same requests, by key:
#: wall-clock stamps and durations (the two runs take their own time),
#: the graph's random instance id, the absolute dump path, the
#: controller's cooldown deadlines, the SLO report's stamp and a retry's
#: remaining backoff (each read off the clock), /status's
#: vertex-program computer, each package's default ("gpu", "tpu"), and
#: span ids, which the ``device_cost`` spans ``_norm`` drops would shift
VOLATILE = {"instance", "computer", "span", "parent", "evaluated_at",
            "submitted_at", "started_at", "finished_at", "queue_ms",
            "exec_ms", "device_ms", "hbm_byte_seconds",
            "wait_ms", "fuse_ms", "device_seconds", "start", "end",
            "duration_ms", "t", "t_recv", "t_send", "cooldown_until",
            "cooldowns", "backoff_s", "retry_at", "last_ok_age_s", "path",
            "dump_dir", "mtime", "bytes", "file"}

_TERMINAL = ("done", "failed", "timeout", "cancelled", "expired")


def _norm(x):
    """A body with every VOLATILE value blanked, and the trace spans the
    two device profilers place differently dropped: JAX's profiler times
    every jitted call, so each of its jobs has a ``device_cost`` span;
    the port's times its three kernel wrappers, which a CPU PageRank,
    SSSP or WCC never calls. The span count of a trace digest follows."""
    if isinstance(x, dict):
        out = {k: ("~" if k in VOLATILE else _norm(v))
               for k, v in x.items()}
        if "children" in out:
            out["children"] = [c for c in out["children"]
                               if c.get("name") != "device_cost"]
        if set(out) >= {"spans", "rounds"} and isinstance(out["spans"],
                                                          int):
            out["spans"] = "~"
        if isinstance(out.get("spans"), list):
            out["spans"] = [c for c in out["spans"]
                            if c.get("name") != "device_cost"]
        return out
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


def _req(srv, path, payload=None, method=None, token=None):
    """One request: (status, content type, body bytes). ``payload`` is a
    JSON value or raw bytes."""
    data = None
    if payload is not None:
        data = payload if isinstance(payload, bytes) \
            else json.dumps(payload).encode()
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}", data=data, headers=headers,
        method=method or ("POST" if data is not None else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _json(srv, path, payload=None, method=None, token=None):
    code, ctype, body = _req(srv, path, payload, method, token)
    assert ctype == "application/json", (path, ctype)
    return code, json.loads(body)


def _both(pair, path, payload=None, method=None):
    """The same request on both servers; asserts equal statuses and
    bodies (after ``_norm``) and returns the port's."""
    got = {w: (c, _norm(b)) for w, (c, b) in (
        (w, _json(srv, path, payload, method)) for w, srv in pair.items())}
    assert got["port"] == got["jax"], path
    return got["port"]


def _poll(srv, job_id, timeout=90.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        code, body = _json(srv, f"/jobs/{job_id}")
        assert code == 200
        if body["status"] in _TERMINAL:
            return body
        time.sleep(0.02)
    raise AssertionError(f"job {job_id} did not finish in {timeout} s")


def _serve(which, g, **kw):
    """``which``'s GraphServer over ``g`` with its own scheduler (an
    isolated registry, autotune off unless asked, the port's on the
    CPU)."""
    mod, J, M = PKGS[which][:3]
    kw.setdefault("autotune", "off")
    sched = J(graph=g, metrics=M(), hbm_budget_bytes=1e12,
              **PKGS[which][-1], **kw)
    return mod.GraphServer(g, port=0, scheduler=sched).start()


#: short lock and id-claim waits: one process on an in-memory store has
#: no clock skew to wait out (both packages read the same two options)
FAST = {"storage.backend": "inmemory", "storage.lock.wait-time": 5,
        "ids.authority.wait-time": 5}


def gods(which: str):
    """The graph of the gods on a twin graph (``torch_twins.gods``) with
    the short waits."""
    g = open_twin(which, config=dict(FAST))
    TWINS[which][4].load(g)
    return g


@pytest.fixture
def gods_pair():
    graphs = {w: gods(w) for w in PKGS}
    yield graphs
    for g in graphs.values():
        g.close()


@pytest.fixture
def pair(gods_pair, monkeypatch):
    # job ids come from a counter a process: both packages' restart at
    # job-1 here, so ids agree whichever test files ran before in this
    # process (port-only serving tests advance only the port's)
    import itertools

    from titan_tpu.olap.serving import jobs as jjobs
    from titan_tpu_torch.olap.serving import jobs as pjobs
    for mod in (jjobs, pjobs):
        monkeypatch.setattr(mod, "_ids", itertools.count(1))
    servers = {w: _serve(w, g) for w, g in gods_pair.items()}
    yield servers
    for srv in servers.values():
        srv.stop()


def _vid(srv, name):
    code, body = _json(srv, "/traversal", {
        "gremlin": f"g.V().has('name','{name}').next().id"})
    assert code == 200
    return body["result"]


# -- graph surface ------------------------------------------------------------

def test_status_schema_and_unknown_paths_match(pair):
    code, status = _both(pair, "/status")
    assert code == 200 and status["backend"] == "inmemory"
    # the vertex-program computer is each package's default
    assert _json(pair["port"], "/status")[1]["computer"] == "gpu"
    assert _json(pair["jax"], "/status")[1]["computer"] == "tpu"
    code, schema = _both(pair, "/schema")
    assert {"name", "age", "father", "battled"} <= \
        {t["name"] for t in schema["types"]}
    for method in ("GET", "POST", "DELETE"):
        code, body = _both(pair, "/nope", {} if method == "POST" else None,
                           method)
        assert code == 404


_SCRIPTS = [
    "g.V().count().next()",
    "g.V().has('name','hercules').out('father')",
    "g.V().has('name','hercules').out_e('battled')",
    "g.V().has('name','hercules').properties('name', 'age')",
    "g.V().has('name','hercules').value_map()",
    "g.V().has('name', 'hercules').union(__.out('father'), "
    "__.out('mother')).values('name')",
    "sorted(v.id for v in g.V().to_list())",
    "g.V().has('name','saturn').in_('father').in_('father')"
    ".values('name')",
    "g.V().group_count().by('name').next()",
    "len(g.E().to_list())",
]


@pytest.mark.parametrize("script", _SCRIPTS)
def test_traversal_scripts_match(pair, script):
    code, body = _both(pair, "/traversal", {"gremlin": script})
    assert code == 200 and body["result"] not in (None, [])


_BAD_SCRIPTS = [
    {"nope": 1}, {"gremlin": "g.V().bogus()"},
    {"gremlin": "this is not ( python"},
    {"gremlin": "nonexistent_binding.foo()"},
    {"gremlin": "graph.management().make_property_key('x', object)"},
    b"{not json",
]


@pytest.mark.parametrize("body", _BAD_SCRIPTS, ids=range(len(_BAD_SCRIPTS)))
def test_traversal_errors_match(pair, body):
    code, out = _both(pair, "/traversal", body)
    assert code == 400 and out["retryable"] is False
    assert _json(pair["port"], "/status")[0] == 200   # still serving


def test_writes_commit_and_read_back_alike(pair):
    code, body = _both(pair, "/traversal", {
        "gremlin": "graph.add_vertex('person', name='newbie').id"})
    vid = body["result"]
    code, body = _both(pair, "/traversal",
                       {"gremlin": f"g.V({vid}).values('name')"})
    assert body["result"] == ["newbie"]


def test_concurrent_mutating_sessions_land_once():
    from titan_tpu_torch import open as popen
    g = popen(dict(FAST))
    srv = pserver.GraphServer(g, port=0, device="cpu").start()
    try:
        errors = []

        def writer(i):
            for j in range(5):
                code, body = _json(srv, "/traversal", {
                    "gremlin": f"graph.tx().add_vertex('person', "
                               f"name='w{i}_{j}')"})
                if code != 200:
                    errors.append(body)
        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        code, body = _json(srv, "/traversal", {
            "gremlin": "g.V().has_label('person').count()"})
        assert code == 200 and body["result"] == [30]
    finally:
        srv.stop()
        g.close()


def test_bearer_token_gate_matches():
    bodies = {}
    for which in PKGS:
        g = open_twin(which, config=dict(FAST))
        srv = PKGS[which][0].GraphServer(g, port=0,
                                         auth_token="s3cret").start()
        try:
            bodies[which] = [
                _json(srv, "/traversal", {"gremlin": "g.V().count()"},
                      token=t) for t in (None, "wrong", "s3cret")]
            bodies[which].append(_json(srv, "/status", token="wrong"))
        finally:
            srv.stop()
            g.close()
    assert bodies["port"] == bodies["jax"]
    assert [c for c, _ in bodies["port"]] == [401, 401, 200, 401]
    assert bodies["port"][0][1]["type"] == "Unauthorized"


# -- the job plane ------------------------------------------------------------

def _jobs_alike(pair, bodies):
    """Submit each body on both servers in turn, poll each to its end;
    returns [(port's final body, its job id)]."""
    out = []
    for body in bodies:
        code, sub = _both(pair, "/jobs", body)
        assert code == 202 and sub["status"] == "queued"
        finals = {w: _poll(srv, sub["job"]) for w, srv in pair.items()}
        assert _norm(finals["port"]) == _norm(finals["jax"]), body
        out.append((finals["port"], sub["job"]))
    return out


def test_jobs_over_the_wire_match(pair):
    vid = _vid(pair["port"], "hercules")
    far = _vid(pair["port"], "cerberus")
    finals = _jobs_alike(pair, [
        {"kind": "bfs", "source": vid, "targets": [vid, far]},
        {"kind": "sssp", "source": vid, "targets": [far]},
        {"kind": "wcc"},
        {"kind": "pagerank", "iterations": 5},
        {"kind": "bfs", "source_dense": 3, "max_levels": 2,
         "tenant": "team-a", "priority": 2}])
    bfs, sssp, wcc, pr, short = (f for f, _ in finals)
    assert bfs["status"] == "done" and bfs["result"]["reached"] == 12
    assert bfs["result"]["targets"][str(vid)] == 0
    assert sssp["status"] == "done" and wcc["result"]["components"] == 1
    assert pr["result"] == {"iterations": 5}
    assert short["tenant"] == "team-a" and short["priority"] == 2
    # the arrays the wire omits, bit-equal in process
    for _, jid in finals:
        res = {w: srv.scheduler().get(jid).result for w, srv in pair.items()}
        for key in ("dist", "labels", "rank"):
            if key in res["jax"]:
                np.testing.assert_array_equal(
                    np.asarray(res["port"][key]), np.asarray(res["jax"][key]))
    code, listing = _both(pair, "/jobs")
    assert listing["stats"]["jobs_total"] == 5
    assert [j["job"] for j in listing["jobs"]] == [j for _, j in finals]
    # a finished job cannot be cancelled; an unknown one is not found
    assert _both(pair, f"/jobs/{finals[0][1]}", method="DELETE")[0] == 409
    assert _both(pair, "/jobs/nope")[0] == 404
    assert _both(pair, "/jobs/nope", method="DELETE")[0] == 404
    for path in ("/tenants", "/live", "/slo", "/controller", "/healthz",
                 "/debug/dumps", "/fleet", f"/trace?job={finals[0][1]}",
                 f"/trace?job={finals[3][1]}"):
        code, _ = _both(pair, path)
        assert code == 200, path


def test_trace_export_drains_once_alike(pair):
    (final, jid), = _jobs_alike(pair, [{"kind": "bfs", "source_dense": 0}])
    code, first = _both(pair, f"/trace/export?job={jid}")
    assert code == 200 and {s["name"] for s in first["spans"]} >= {
        "job", "submit", "queue", "run", "round", "done"}
    code, again = _both(pair, f"/trace/export?job={jid}")
    assert again["spans"] == [] and again["dropped"] == 0
    assert _both(pair, "/trace/export")[0] == 400
    assert _both(pair, "/trace")[0] == 400
    assert _both(pair, "/trace?job=never")[0] == 404


_BAD_JOBS = [
    {"kind": "explode"},
    {"kind": "bfs", "source_dense": 0, "timeout_s": "soon"},
    {"kind": "bfs", "source_dense": 0, "priority": "high"},
    {"kind": "bfs", "source_dense": 0, "max_levels": "many"},
    b"{not json",
]


@pytest.mark.parametrize("body", _BAD_JOBS, ids=range(len(_BAD_JOBS)))
def test_bad_job_bodies_are_400_alike(pair, body):
    code, out = _both(pair, "/jobs", body)
    assert code == 400 and out["retryable"] is False


def test_numeric_fields_are_coerced_at_the_wire_alike(pair):
    (final, _), = _jobs_alike(pair, [
        {"kind": "bfs", "source_dense": 0, "timeout_s": "30",
         "max_levels": "5"}])
    assert final["status"] == "done"


def test_delete_cancels_a_queued_job_alike(gods_pair):
    pair = {w: _serve(w, g, autostart=False) for w, g in gods_pair.items()}
    try:
        code, sub = _both(pair, "/jobs", {"kind": "bfs", "source_dense": 0})
        code, body = _both(pair, f"/jobs/{sub['job']}", method="DELETE")
        assert code == 200 and body["status"] == "cancelled"
        for srv in pair.values():
            assert srv.scheduler()._metrics.counter_value(
                "serving.jobs.cancelled") == 1
    finally:
        for srv in pair.values():
            srv.stop()


def test_concurrent_submits_fuse_into_one_batch_alike(gods_pair):
    """Eight BFS jobs POSTed from eight threads to a paused scheduler fuse
    into one batch of 8 in both packages, each with its own result."""
    pair = {w: _serve(w, g, autostart=False) for w, g in gods_pair.items()}
    try:
        code, body = _both(pair, "/traversal", {
            "gremlin": "sorted(v.id for v in g.V().to_list())"})
        vids = body["result"][:8]
        jobs = {}

        def submit(w, vid):
            code, sub = _json(pair[w], "/jobs", {
                "kind": "bfs", "source": vid, "targets": [vids[0]]})
            assert code == 202
            jobs[(w, vid)] = sub["job"]
        threads = [threading.Thread(target=submit, args=(w, v))
                   for w in pair for v in vids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert len(jobs) == 16
        for srv in pair.values():
            srv.scheduler().start()
        for vid in vids:
            finals = {w: _poll(pair[w], jobs[(w, vid)]) for w in pair}
            for f in finals.values():
                assert f["status"] == "done" and f["batch_k"] == 8
            assert finals["port"]["result"] == finals["jax"]["result"]
        for srv in pair.values():
            assert srv.scheduler()._metrics.histogram(
                "serving.batch.occupancy").max == 8
    finally:
        for srv in pair.values():
            srv.stop()


def test_tenant_quota_429_and_slo_endpoints_alike(gods_pair):
    pair = {}
    for w, g in gods_pair.items():
        ten, slo = PKGS[w][4], PKGS[w][5]
        pair[w] = _serve(w, g, autostart=False, enforce_quotas=True,
                         quotas={"flood": ten.TenantQuota(max_in_flight=1)},
                         slos=[slo("flood-avail", tenant="flood",
                                   success_rate=0.999)])
    try:
        vid = _vid(pair["port"], "hercules")
        code, j1 = _both(pair, "/jobs", {"kind": "bfs", "source": vid,
                                         "tenant": "flood"})
        assert code == 202 and j1["tenant"] == "flood"
        code, err = _both(pair, "/jobs", {"kind": "bfs", "source": vid,
                                          "tenant": "flood"})
        assert code == 429 and err["type"] == "QuotaExceeded"
        assert err["retryable"] is True
        code, j2 = _both(pair, "/jobs", {"kind": "bfs", "source": vid})
        assert j2["tenant"] == "default"
        for srv in pair.values():
            srv.scheduler().start()
            assert _poll(srv, j1["job"])["status"] == "done"
            assert _poll(srv, j2["job"])["status"] == "done"
        code, body = _both(pair, "/tenants")
        assert body["enforce_quotas"] is True
        assert body["tenants"]["flood"]["rejected"] == 1
        assert body["quotas"]["flood"]["max_in_flight"] == 1
        code, body = _both(pair, "/slo")
        (s,) = body["slos"]
        assert s["slo"] == "flood-avail" and s["sli"]["ok"] is True
        assert s["windows"]["300s"]["burn_rate"] == 0.0
    finally:
        for srv in pair.values():
            srv.stop()


def test_retried_bfs_trace_tree_over_http_alike(gods_pair, tmp_path):
    """A fused pair whose faulted member crashes at level 2, retries and
    resumes from its checkpoint: the same span tree in both packages."""
    pair, jobs = {}, {}
    for w, g in gods_pair.items():
        pair[w] = _serve(w, g, autostart=False,
                         checkpoint_dir=str(tmp_path / w))
    try:
        code, mate = _both(pair, "/jobs", {"kind": "bfs", "source_dense": 0,
                                           "max_retries": 1})
        for w, srv in pair.items():
            spec, fault = PKGS[w][6], PKGS[w][7]
            jobs[w] = srv.scheduler().submit(spec(
                kind="bfs", params={"source_dense": 1,
                                    "faults": fault(crash_at_round=2)},
                max_retries=1, checkpoint_every=1)).id
            srv.scheduler().start()
        assert jobs["port"] == jobs["jax"]
        finals = {w: _poll(srv, jobs[w]) for w, srv in pair.items()}
        assert _norm(finals["port"]) == _norm(finals["jax"])
        assert finals["port"]["attempt"] == 2
        code, tree = _both(pair, f"/trace?job={jobs['port']}")

        def names(node, acc):
            acc.append(node["name"])
            for c in node["children"]:
                names(c, acc)
            return acc
        got = names(tree["spans"][0], [])
        for want in ("submit", "queue", "fuse", "run", "round",
                     "checkpoint", "retrying", "resume", "done"):
            assert want in got, (want, got)
        assert _poll(pair["port"], mate["job"])["status"] == "done"
    finally:
        for srv in pair.values():
            srv.stop()


def test_tracing_off_leaves_no_trace_alike(gods_pair):
    pair = {w: _serve(w, g, tracing=False) for w, g in gods_pair.items()}
    try:
        (final, jid), = _jobs_alike(pair, [{"kind": "bfs",
                                            "source_dense": 0}])
        assert "trace" not in final
        assert _both(pair, f"/trace?job={jid}")[0] == 404
    finally:
        for srv in pair.values():
            srv.stop()


# -- the interactive lane -----------------------------------------------------

def _lane_bodies(vid):
    return [
        {"start": [vid], "dir": "both", "hops": 2, "terminal": "count"},
        {"start": [vid], "dir": "out", "hops": 1, "terminal": "id"},
        {"start": [vid], "dir": "in", "hops": 2,
         "terminal": {"values": "name"}},
        {"start": [vid], "dir": "out", "hops": 1, "labels": ["father"],
         "terminal": "id", "tenant": "team-a"},
        {"gremlin": f"g.V({vid}).both().both().dedup().count()"},
        {"gremlin": f"g.V({vid}).out().has('name', 'jupiter').id_()"},
        {"gremlin": f"g.V({vid}).out('father').values('name')"},
        {"kind": "ppr", "source": vid, "iterations": 5, "top_k": 3},
    ]


@pytest.mark.parametrize("i", range(8))
def test_traverse_bodies_match(pair, i):
    vid = _vid(pair["port"], "hercules")
    code, body = _both(pair, "/traverse", _lane_bodies(vid)[i])
    assert code == 200 and "result" in body
    # has() and a chain without its terminal dedup are not compiled
    assert body["fallback"] is (i in (5, 6))


_BAD_TRAVERSE = [[1, 2], {"start": [1], "dir": "sideways", "hops": 1},
                 {"gremlin": "1 + 1"}, {"gremlin": "g.V(("},
                 {"start": [], "hops": 1}, b"{not json"]


@pytest.mark.parametrize("body", _BAD_TRAVERSE,
                         ids=range(len(_BAD_TRAVERSE)))
def test_bad_traverse_bodies_are_400_alike(pair, body):
    code, out = _both(pair, "/traverse", body)
    assert code == 400 and out["retryable"] is False


def test_concurrent_point_queries_fuse_once():
    """Four concurrent /traverse counts on a fresh port server (its lane
    made by the first handler thread) fuse into one batch, each equal to
    the JAX server's answer."""
    graphs = {w: gods(w) for w in PKGS}
    port = _serve("port", graphs["port"], interactive_window_s=5.0,
                  interactive_max_fuse=4)
    jax = _serve("jax", graphs["jax"])
    try:
        code, body = _json(port, "/traversal", {
            "gremlin": "sorted(v.id for v in g.V().to_list())"})
        vids = body["result"][:4]
        out = [None] * 4
        gate = threading.Barrier(4)

        def go(i):
            gate.wait()
            out[i] = _json(port, "/traverse", {
                "start": [vids[i]], "dir": "both", "hops": 2,
                "terminal": "count"})
        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert {(c, b["fused_k"], b["batch"]) for c, b in out} == {
            (200, 4, out[0][1]["batch"])}
        for vid, (_, b) in zip(vids, out):
            code, ref = _json(jax, "/traverse", {
                "start": [vid], "dir": "both", "hops": 2,
                "terminal": "count"})
            assert b["result"] == ref["result"]
    finally:
        port.stop()
        jax.stop()
        for g in graphs.values():
            g.close()


# -- probes, health and the flight recorder -----------------------------------

def test_probes_build_no_scheduler_and_healthz_does(gods_pair):
    pair = {"jax": jserver.GraphServer(gods_pair["jax"], port=0),
            "port": pserver.GraphServer(gods_pair["port"], port=0,
                                        device="cpu")}
    for srv in pair.values():
        srv.start()
    try:
        for path in ("/tenants", "/slo", "/controller", "/debug/dumps",
                     "/fleet", "/trace?job=x"):
            _both(pair, path)
        assert _both(pair, "/debug/dump", {})[0] == 409
        for srv in pair.values():
            assert srv._scheduler is None
            code, ctype, _ = _req(srv, "/metrics")
            assert code == 200 and ctype == CONTENT_TYPE
            assert srv._scheduler is None
        code, health = _both(pair, "/healthz")
        assert code == 200 and health["ready"] is True
        assert health["checks"] == {"scheduler_open": True,
                                    "snapshot_pool":
                                        "graph-backed (0 resident)",
                                    "ledger_ok": True}
        assert pair["port"]._scheduler.device == torch.device("cpu")
    finally:
        for srv in pair.values():
            srv.stop()


def test_device_none_means_cuda(gods_pair):
    """No device and no scheduler: the lazy scheduler is CUDA's, and
    without a card /healthz says why it is not ready (nothing carries
    on on the CPU)."""
    srv = pserver.GraphServer(gods_pair["port"], port=0).start()
    try:
        assert srv.device is None
        if torch.cuda.is_available():
            assert srv.scheduler().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                srv.scheduler()
            code, body = _json(srv, "/healthz")
            assert code == 503 and body["ready"] is False
            assert "no CUDA device" in body["checks"]["scheduler"]
            code, body = _json(srv, "/jobs", {"kind": "bfs",
                                              "source_dense": 0})
            assert code == 500 and body["type"] == "RuntimeError"
    finally:
        srv.stop()


def test_debug_dump_with_a_flight_recorder_alike(gods_pair, tmp_path):
    pair = {w: _serve(w, g, flight_dir=str(tmp_path / w))
            for w, g in gods_pair.items()}
    try:
        (final, jid), = _jobs_alike(pair, [{"kind": "bfs",
                                            "source_dense": 0}])
        code, dump = _both(pair, "/debug/dump", {"job": jid})
        assert code == 200
        for w, srv in pair.items():
            code, body = _json(srv, "/debug/dump", {"job": jid})
            assert body["path"].startswith(str(tmp_path / w))
        code, index = _both(pair, "/debug/dumps")
        assert index["enabled"] and len(index["dumps"]) == 2
        assert _both(pair, "/debug/dump", [1])[0] == 400
    finally:
        for srv in pair.values():
            srv.stop()


def test_metrics_exposition_over_http(pair):
    import re
    _jobs_alike(pair, [{"kind": "bfs", "source_dense": 0},
                       {"kind": "wcc"}])
    pair_label = r"[a-zA-Z0-9_]+=\"([^\"\\]|\\.)*\""
    sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{" + pair_label
                        + r"(," + pair_label + r")*\})? [+-]?(\d+\.?\d*"
                        r"([eE][+-]?\d+)?)$")
    bodies = {}
    for w, srv in pair.items():
        code, ctype, raw = _req(srv, "/metrics")
        assert code == 200 and ctype == CONTENT_TYPE
        text = raw.decode()
        for ln in text.splitlines():
            if ln and not ln.startswith("#"):
                assert sample.match(ln), ln
        # the serving families' counters; the device.* families name
        # each package's own kernels
        bodies[w] = sorted(ln for ln in text.splitlines()
                           if ln.startswith(("serving_jobs_",
                                             "# TYPE serving_")))
    assert bodies["port"] == bodies["jax"]
    assert "serving_jobs_completed 2" in bodies["port"]


# -- units --------------------------------------------------------------------

_ERRORS = [("errors", "TemporaryBackendError"),
           ("errors", "PermanentBackendError"),
           ("errors", "TemporaryLockingError"),
           ("errors", "PermanentLockingError"),
           ("errors", "IDPoolExhaustedError"),
           ("errors", "SchemaViolationError"),
           ("errors", "QueryError"), ("errors", "TitanError"),
           ("tenants", "QuotaExceeded"), ("builtins", "SyntaxError"),
           ("builtins", "NameError"), ("builtins", "TypeError"),
           ("builtins", "ValueError"), ("builtins", "KeyError"),
           ("builtins", "AttributeError"), ("builtins", "RuntimeError"),
           ("builtins", "MemoryError")]


@pytest.mark.parametrize("where,name", _ERRORS)
def test_wire_error_status_per_class_matches(where, name):
    import builtins
    got = {}
    for w, (mod, _, _, errs, ten, *_r) in PKGS.items():
        cls = getattr({"errors": errs, "tenants": ten,
                       "builtins": builtins}[where], name)
        got[w] = mod.wire_error(cls("boom"))
    assert got["port"] == got["jax"]
    assert got["port"][1]["type"] == name
    e = perr.InvalidElementError("gone", element=None)
    assert pserver.wire_error(e) == jserver.wire_error(
        jerr.InvalidElementError("gone", element=None))


def test_jsonify_matches_and_sends_numpy_and_torch_as_values(gods_pair):
    deep = {"a": {"b": {"c": {"d": {"e": {"f": 1}}}}}, "t": (1, "x"),
            "s": {3}, "n": None, "f": 2.5}
    assert pserver.jsonify(deep) == jserver.jsonify(deep)
    got = pserver.jsonify({"i": np.int64(3), "f": np.float32(0.5),
                           "b": np.bool_(True), "a": np.arange(3),
                           "t": torch.tensor(7), "v": torch.ones(2),
                           "l": [np.int32(1), torch.tensor(2.5)]})
    assert got == {"i": 3, "f": 0.5, "b": True, "a": [0, 1, 2], "t": 7,
                   "v": [1.0, 1.0], "l": [1, 2.5]}
    assert type(got["i"]) is int and type(got["b"]) is bool
    assert json.loads(json.dumps(got)) == got
    # elements of both packages' graphs get the same envelopes
    outs = {}
    for w, g in gods_pair.items():
        mod = PKGS[w][0]
        t = g.traversal()
        outs[w] = [mod.jsonify(t.V().has("name", "hercules").next()),
                   mod.jsonify(t.E().limit(1).to_list()),
                   mod.jsonify(t.V().has("name", "hercules")
                               .properties("name").to_list())]
        g.rollback()
    assert outs["port"] == outs["jax"]
    assert outs["port"][0]["@type"] == "vertex"


def test_from_yaml_and_the_cli(tmp_path, capsys):
    conf = tmp_path / "server.yaml"
    conf.write_text("host: 127.0.0.1\nport: 0\nauth-token: t0k\n"
                    "graph:\n  storage.backend: inmemory\n")
    srv = pserver.from_yaml(str(conf))
    assert srv.device is None and srv.auth_token == "t0k"
    srv.start()
    try:
        code, body = _json(srv, "/status", token="t0k")
        assert code == 200 and body["backend"] == "inmemory"
    finally:
        srv.stop()
        srv.graph.close()
    with pytest.raises(SystemExit) as exc:
        pserver.main([])
    assert exc.value.code == 2
    assert "python -m titan_tpu_torch.server" in capsys.readouterr().err

