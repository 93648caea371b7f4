"""The port's Prometheus exposition and federation
(``titan_tpu_torch/obs/promexport.py``, ``obs/federate.py``) against the
JAX package's: the same registry operations render byte-equal text, and
two Federators fed the same peers render, evict and roll up alike."""

import json
import re
import urllib.request

import pytest

from titan_tpu.obs import federate as jfed
from titan_tpu.obs import promexport as jprom
from titan_tpu.utils.metrics import MetricManager as JM
from titan_tpu_torch.errors import TemporaryBackendError
from titan_tpu_torch.obs import federate as pfed
from titan_tpu_torch.obs import promexport as pprom
from titan_tpu_torch.utils.metrics import MetricManager as PM

#: per package: (promexport, federate, MetricManager)
PKGS = {"jax": (jprom, jfed, JM), "port": (pprom, pfed, PM)}

_LABEL_PAIR = r"[a-zA-Z0-9_]+=\"([^\"\\]|\\.)*\""
_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{" + _LABEL_PAIR + r"(," + _LABEL_PAIR + r")*\})? "
    r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?)$")


def _counters(m):
    m.counter("serving.jobs.submitted").inc(3)
    m.counter("serving.jobs.completed", labels={"kind": "bfs",
                                                "tenant": "a"}).inc(2)
    m.counter("serving.jobs.completed", labels={"kind": "wcc",
                                                "tenant": "b"}).inc()
    m.counter("serving.queue.depth", gauge=True).inc(4)
    m.counter("serving.queue.depth", gauge=True).inc(-1)
    m.counter("odd-name.with/slashes").inc(7)
    m.counter("9lives").inc()


def _timers(m):
    for ms in (1.5, 20.0, 3.25):
        m.timer("store.get_slice").update(int(ms * 1e6))
    m.timer("device.exec.ms", labels={"kernel": "seg_scan"}).update(
        2_500_000)
    m.timer("device.exec.ms", labels={"kernel": "frontier_round"}).update(
        1_234_567)


def _histograms(m):
    h = m.histogram("serving.job.latency_ms", seed=3)
    for v in (5.0, 1.0, 9.5, 2.25, 7.0):
        h.update(v)
    for k, vs in (("bfs", (3.0, 4.0)), ("sssp", (0.125,))):
        c = m.histogram("serving.job.latency_ms", labels={"kind": k})
        for v in vs:
            c.update(v)
    m.histogram("serving.batch.occupancy").update(16)


def _gauges(m):
    m.gauge("serving.hbm.resident_bytes", lambda: 1112.0)
    m.gauge("serving.pool.snapshots").set(2)
    # a children-only ratio family exports no unlabeled sample
    m.gauge("serving.slo.burn_rate", labels={"slo": "p95",
                                             "window": "5m"}).set(0.5)
    m.gauge("serving.slo.burn_rate", labels={"slo": "p95",
                                             "window": "1h"}).set(1.75)
    m.gauge("controller.knob.value").set(3)
    m.gauge("controller.knob.value", labels={"knob": "k"}).set(16)


def _escapes(m):
    m.counter("labels", labels={"v": 'q"uote\\back\nline',
                                "bad-key.x": "1"}).inc()
    m.counter("big").inc(10 ** 16)
    m.timer("tiny").update(1)
    m.gauge("ratio").set(1 / 3)


def _help_names(m):
    for name in sorted(jprom.HELP):
        m.counter(name).inc()


OPS = {"empty": lambda m: None, "counters": _counters, "timers": _timers,
       "histograms": _histograms, "gauges": _gauges, "escapes": _escapes,
       "help": _help_names,
       "all": lambda m: [f(m) for f in (_counters, _timers, _histograms,
                                        _gauges, _escapes)]}


def _render(which: str, case: str) -> str:
    prom, _, M = PKGS[which]
    m = M()
    OPS[case](m)
    return prom.render_prometheus(m)


@pytest.mark.parametrize("case", sorted(OPS))
def test_render_is_byte_equal(case):
    text = _render("port", case)
    assert text == _render("jax", case)
    assert text.endswith("\n")
    for line in text.splitlines():
        if line and not line.startswith("#"):
            assert _SAMPLE.match(line), line


def test_render_has_the_families_and_labels():
    text = _render("port", "all")
    assert "# TYPE serving_queue_depth gauge\nserving_queue_depth 3" in text
    assert 'serving_jobs_completed{kind="bfs",tenant="a"} 2' in text
    assert "serving_jobs_completed 3" in text      # the children's sum
    assert 'device_exec_ms_seconds_count{kernel="seg_scan"} 1' in text
    assert 'serving_job_latency_ms{kind="bfs",quantile="0.5"}' in text
    assert "\nserving_slo_burn_rate " not in text
    assert 'labels{bad_key_x="1",v="q\\"uote\\\\back\\nline"} 1' in text
    assert "odd_name_with_slashes 7" in text and "_9lives 1" in text


def test_help_registry_content_type_and_names_match():
    assert pprom.HELP == jprom.HELP
    assert pprom.CONTENT_TYPE == jprom.CONTENT_TYPE
    for name in ("a.b", "9x", "", "ok_name:x", "é"):
        assert pprom.sanitize(name) == jprom.sanitize(name), name
        assert pprom._esc(name + '"\n\\') == jprom._esc(name + '"\n\\')


# -- federation ---------------------------------------------------------------

_PEER_A = """\
# HELP scan_remote_splits_served splits executed on this scan-worker node
# TYPE scan_remote_splits_served counter
scan_remote_splits_served 3
# TYPE serving_queue_depth gauge
serving_queue_depth 1
"""

_PEER_B = """\
# HELP scan_remote_splits_served splits executed on this scan-worker node
# TYPE scan_remote_splits_served counter
scan_remote_splits_served 5
scan_remote_splits_served{kind="repair"} 2
# TYPE serving_queue_depth gauge
serving_queue_depth 4
"""


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _feds(fetches, **kw):
    """One Federator of each package over the same scripted fetch:
    ``fetches[(url, path)]`` is a body or an exception to raise."""
    def fetch(url, path):
        got = fetches[(url, path)]
        if isinstance(got, BaseException):
            raise got
        return got
    clock = FakeClock()
    return clock, {which: fed.Federator(metrics=M(), clock=clock,
                                        fetch=fetch, **kw)
                   for which, (_, fed, M) in PKGS.items()}


def _both(feds, call):
    out = {which: call(f) for which, f in feds.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def test_federated_render_is_equal_and_labels_each_instance():
    fetches = {("http://a:1", "/metrics"): _PEER_A,
               ("http://a:1", "/healthz"): '{"live": true}',
               ("http://b:2", "/metrics"): _PEER_B,
               ("http://b:2", "/healthz"): '{"live": true}'}
    _, feds = _feds(fetches)
    for f in feds.values():
        f.add_peer("http://a:1", instance="a")
        f.add_peer("b:2")
    assert _both(feds, lambda f: f.scrape()) == {"a": True, "b:2": True}
    local = {}
    for which, (prom, _, M) in PKGS.items():
        m = M()
        m.counter("scan.remote.splits_dispatched").inc(9)
        local[which] = prom.render_prometheus(m)
    body = feds["port"].render(local["port"])
    assert body == feds["jax"].render(local["jax"])
    assert body.count("# TYPE scan_remote_splits_served counter") == 1
    assert body.count("# HELP scan_remote_splits_served") == 1
    assert "scan_remote_splits_dispatched 9" in body
    assert 'scan_remote_splits_served{instance="a"} 3' in body
    assert 'scan_remote_splits_served{instance="b:2",kind="repair"} 2' \
        in body
    assert _both(feds, lambda f: f.fleet())["up"] == 2


@pytest.mark.parametrize("sample,instance", [
    ("x 1", 'a"b\\c\nd'), ("x{} 1", "i"), ('x{l="v"} 1', "i"),
    ('x{l="v",m="w"} 2.5', "host:9"), ("x_count 3", "i")])
def test_inject_instance_and_parse_families_match(sample, instance):
    assert pfed._inject_instance(sample, instance) == \
        jfed._inject_instance(sample, instance)
    for text in (_PEER_A, _PEER_B, sample + "\n"):
        assert pfed._parse_families(text) == jfed._parse_families(text)


def test_series_cap_drops_and_counts_alike():
    big = "# TYPE fam counter\n" + "\n".join(
        f'fam{{k="{i}"}} 1' for i in range(50)) + "\n"
    _, feds = _feds({("http://a:1", "/metrics"): big,
                     ("http://a:1", "/healthz"): "{}"},
                    max_series_per_peer=10)
    for f in feds.values():
        f.add_peer("http://a:1", instance="a")
        f.scrape()
    body = _both(feds, lambda f: f.render(""))
    assert body.count('instance="a"') == 10
    assert _both(feds, lambda f: f._metrics.counter_value(
        "obs.federate.series_dropped")) == 40


def test_eviction_and_recovery_step_alike():
    fetches = {("http://a:1", "/metrics"): _PEER_A,
               ("http://a:1", "/healthz"):
                   '{"live": true, "ready": true, "n": 11}',
               ("http://b:2", "/metrics"): TemporaryBackendError("down"),
               ("http://b:2", "/healthz"): TemporaryBackendError("down")}
    clock, feds = _feds(fetches, max_failures=3)
    for f in feds.values():
        f.add_peer("http://a:1", instance="a")
        f.add_peer("http://b:2", instance="b")
    views = []
    for step in range(4):
        _both(feds, lambda f: f.scrape())
        clock.t += 7.0
        views.append(_both(feds, lambda f: f.fleet()))
    rows = {p["instance"]: p for p in views[-1]["peers"]}
    assert rows["a"]["up"] and rows["a"]["last_ok_age_s"] == 7.0
    assert rows["a"]["health"]["n"] == 11
    assert rows["b"]["evicted"] and rows["b"]["consecutive_failures"] == 4
    assert "down" in rows["b"]["last_error"]
    assert not {p["instance"]: p for p in views[1]["peers"]}["b"][
        "evicted"]
    assert 'instance="b"' not in _both(feds, lambda f: f.render(""))
    fetches[("http://b:2", "/metrics")] = _PEER_B
    fetches[("http://b:2", "/healthz")] = "{}"
    _both(feds, lambda f: f.scrape())
    assert _both(feds, lambda f: f.fleet())["up"] == 2
    assert _both(feds, lambda f: (
        f._metrics.counter_value("obs.federate.evicted"),
        f._metrics.counter_value("obs.federate.errors",
                                 labels={"instance": "b"}),
        f._metrics.counter_value("obs.federate.scrapes"))) == (1, 4, 10)


# -- the server's /metrics?federate=1 and /fleet ------------------------------

def _get(srv, path):
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}{path}")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


@pytest.fixture
def servers():
    import titan_tpu
    import titan_tpu_torch
    from titan_tpu.server import GraphServer as JS
    from titan_tpu_torch.server import GraphServer as PS
    out = {}
    for which, pkg, S in (("jax", titan_tpu, JS),
                          ("port", titan_tpu_torch, PS)):
        g = pkg.open("inmemory")
        out[which] = (g, S(g, port=0).start())
    yield {which: srv for which, (_, srv) in out.items()}
    for g, srv in out.values():
        srv.stop()
        g.close()


def test_server_federation_surface_matches(servers):
    fetches = {("http://a:1", "/metrics"): _PEER_A,
               ("http://a:1", "/healthz"): '{"live": true}'}
    bodies = {}
    for which, srv in servers.items():
        assert json.loads(_get(srv, "/fleet")[2]) == {"enabled": False,
                                                      "peers": []}
        _, fed, M = PKGS[which]
        srv.federator = fed.Federator(metrics=M(), clock=FakeClock(),
                                      fetch=lambda u, p: fetches[(u, p)])
        srv.federator.add_peer("http://a:1", instance="a")
        code, ctype, body = _get(srv, "/metrics")
        assert code == 200 and ctype == pprom.CONTENT_TYPE
        assert 'instance="a"' not in body
        code, ctype, body = _get(srv, "/metrics?federate=1")
        assert code == 200 and ctype == pprom.CONTENT_TYPE
        # sorted: where a peer's family lands depends on the families
        # the process-wide local registry already holds
        bodies[which] = sorted(ln for ln in body.splitlines()
                               if 'instance="a"' in ln)
        fl = json.loads(_get(srv, "/fleet")[2])
        assert fl["enabled"] and fl["up"] == 1
        assert fl["peers"][0]["health"] == {"live": True}
    assert bodies["port"] == bodies["jax"]
    assert 'scan_remote_splits_served{instance="a"} 3' in bodies["port"]
