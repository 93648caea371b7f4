"""The port's interactive lane (titan_tpu_torch.olap.serving.interactive)
against the JAX package's, on the CPU.

The compiler (``compile_steps``, ``plan_from_wire`` with its 400 cases)
gives the JAX plans field by field, the direction by name; the collector
groups and orders like JAX's; and the lane on ``JobScheduler(snapshot=
...)`` answers like the JAX lane on the same arrays: the repo-shared
n=192 shape (out/in/both x depths 1-4 x id/count, held to a numpy
expansion too) and the JAX test's 48-vertex labeled ``social`` graph
(values, multi-start, unknown ids, mixed-label chains), under a live
overlay, with personalized PageRank, the depth ceiling, quotas, tenants
and the metric names.

Fusion is deterministic: K threads submit while the lane is stopped, and
the lane starts once its collector holds all K; no test waits on a fuse
window."""

import threading
import time

import numpy as np
import pytest
import torch

import titan_tpu
from titan_tpu.olap.live.overlay import DeltaOverlay as JaxOverlay
from titan_tpu.olap.serving import interactive as JI
from titan_tpu.olap.serving.interactive import collector as JCol
from titan_tpu.olap.serving.scheduler import JobScheduler as JaxScheduler
from titan_tpu.olap.serving.tenants import QuotaExceeded as JaxQuotaExceeded
from titan_tpu.olap.serving.tenants import TenantQuota as JaxQuota
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu.utils.metrics import MetricManager as JaxMetrics
import titan_tpu_torch.models.bfs_hybrid as PH
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.live import DeltaOverlay, EpochCompactor
from titan_tpu_torch.olap.serving import JobScheduler, TenantQuota
from titan_tpu_torch.olap.serving import interactive as PI
from titan_tpu_torch.olap.serving.interactive import collector as PCol
from titan_tpu_torch.olap.serving.interactive import compile as PComp
from titan_tpu_torch.olap.serving.tenants import QuotaExceeded
from titan_tpu_torch.traversal import dsl as PDsl
from titan_tpu_torch.utils.metrics import MetricManager

N, M, SEED = 192, 900, 42
LABELS = {0: "a", 1: "b", 2: "c"}
CPU = torch.device("cpu")


def arrays(seed=SEED):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, M).astype(np.int32)
    dst = rng.integers(0, N, M).astype(np.int32)
    labs = rng.integers(0, 3, M).astype(np.int32)
    return src, dst, labs


@pytest.fixture(scope="module")
def shared():
    """The n=192 labeled multigraph in both packages, one scheduler
    each."""
    src, dst, labs = arrays()
    js = JS.from_arrays(N, src, dst, labels=labs, label_names=LABELS)
    ps = PS.from_numpy(js)
    jsch = JaxScheduler(snapshot=js, autostart=False)
    psch = JobScheduler(snapshot=ps, autostart=False, device="cpu")
    yield (src, dst, labs), jsch, psch
    jsch.close()
    psch.close()


@pytest.fixture(scope="module")
def social():
    """tests/test_serving_interactive.py's 48-vertex labeled graph, its
    symmetrized snapshot with the name and age columns attached, and the
    port snapshot of the same arrays (``from_numpy`` copies the
    columns)."""
    g = titan_tpu.open("inmemory")
    rng = np.random.default_rng(42)
    n = 48
    tx = g.new_transaction()
    vs = [tx.add_vertex("person", name=f"p{i}", age=int(rng.integers(1, 90)))
          for i in range(n)]
    for lab, m in (("knows", 90), ("likes", 60)):
        for a, b in zip(rng.integers(0, n, m), rng.integers(0, n, m)):
            if a != b:
                vs[int(a)].add_edge(lab, vs[int(b)])
    tx.commit()
    js = JS.build(g, directed=False)
    js.attach_vertex_values(g, ["name", "age"])
    ps = PS.from_numpy(js)
    jsch = JaxScheduler(snapshot=js, autostart=False)
    psch = JobScheduler(snapshot=ps, autostart=False, device="cpu")
    yield g, js, ps, jsch, psch
    jsch.close()
    psch.close()
    js.close()
    g.close()


def run_fused(lane, plans, tenants=None, timeout=60.0):
    """Submit ``plans`` from one thread each while ``lane`` is stopped,
    start it once its collector holds them all, and return the results
    (or the raised errors) in order."""
    out = [None] * len(plans)
    tenants = tenants or [None] * len(plans)

    def go(i):
        try:
            out[i] = lane.submit(plans[i], tenant=tenants[i])
        except Exception as e:              # handed back to the test
            out[i] = e

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(plans))]
    for t in threads:
        t.start()
    deadline = time.time() + timeout
    while lane.collector.depth() < len(plans):
        assert time.time() < deadline, "requests never reached the lane"
        time.sleep(0.001)
    lane.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive()
    return out


def lanes(jsch, psch, max_fuse=16):
    return (JI.InteractiveLane(jsch, window_s=0.001, max_fuse=max_fuse,
                               autostart=False),
            PI.InteractiveLane(psch, window_s=0.001, max_fuse=max_fuse,
                               autostart=False))


def both_fused(jsch, psch, bodies, **kw):
    """The same wire bodies through a JAX lane and a port lane, each as
    one fused batch; returns the two result lists."""
    jl, pl = lanes(jsch, psch)
    try:
        jr = run_fused(jl, [JI.plan_from_wire(b) for b in bodies], **kw)
        pr = run_fused(pl, [PI.plan_from_wire(b) for b in bodies], **kw)
    finally:
        jl.close()
        pl.close()
    return jr, pr


def same_answer(jres, pres):
    assert type(jres["result"]) is type(pres["result"])
    if isinstance(pres["result"], list):
        assert sorted(map(str, pres["result"])) == \
            sorted(map(str, jres["result"]))
    else:
        assert pres["result"] == jres["result"]
    for k in ("fused_k", "hops", "epoch"):
        assert pres[k] == jres[k], k


#: the orientation a chain sweeps on a FIXED snapshot: the pool leases it
#: whatever ``directed`` asks (ROADMAP queue 3, item 5, as in JAX), so
#: ``both()`` runs on this directed graph's forward CSR, where a candidate
#: joins through its out-neighbours: the in() expansion
SWEPT = {"out": "out", "in": "in", "both": "in"}


def expand(src, dst, labs, seeds, direction, hop_labels):
    """The hop set by plain numpy: each hop's edges filtered by its label
    codes (None = every edge), followed out, in or both ways."""
    cur = np.zeros(N, bool)
    cur[list(seeds)] = True
    for codes in hop_labels:
        keep = np.ones(M, bool) if codes is None else np.isin(labs, codes)
        s, d = src[keep], dst[keep]
        nxt = np.zeros(N, bool)
        if direction in ("out", "both"):
            nxt[d[cur[s]]] = True
        if direction in ("in", "both"):
            nxt[s[cur[d]]] = True
        cur = nxt
    return np.flatnonzero(cur)


# -- compile -------------------------------------------------------------------

def same_plan(jp, pp):
    if isinstance(pp, PI.PPRPlan):
        assert isinstance(jp, JI.PPRPlan) and pp.fuse_key() == jp.fuse_key()
        assert vars(pp) == vars(jp)
        return
    assert isinstance(pp, PI.TraversalPlan)
    assert pp.direction.name == jp.direction.name
    assert isinstance(pp.direction, PI.Direction)
    for f in ("start_ids", "labels", "depth", "terminal", "hop_labels"):
        assert getattr(pp, f) == getattr(jp, f), f
    assert pp.describe() == jp.describe()


def _chains(T, anon=None):
    if anon is None:
        from titan_tpu.traversal.dsl import anon
    return [
        T().V(1).out().out().dedup().id_(),
        T().V(1, 2).in_("knows").dedup().count(),
        T().V(1).both("knows", "likes").both("knows", "likes")
        .dedup().values("name"),
        T().V(1).out("knows").out("likes").dedup().id_(),
        T().V(1).repeat(anon().out("knows")).times(3).dedup().count(),
        T().V(1).out().id_(),                        # no dedup
        T().V(1).out().in_().dedup().id_(),          # mixed direction
        T().V(1).out("knows").out().dedup().id_(),   # all-labels hop
        T().V().out().dedup().id_(),                 # no ids
        T().V(1).dedup().id_(),                      # no hops
        T().V(1).out().dedup().values("a", "b"),     # two keys
        T().V(1).out().out().out().out().out().dedup().id_(),  # too deep
        T().V(1).has("name", "p1").out().dedup().count(),
        T().V(1).repeat(anon().out().in_()).times(2).dedup().count(),
    ]


def test_compile_steps_equals_jax(social):
    g = social[0]
    T = g.traversal
    got = 0
    ported = _chains(lambda: PDsl.GraphTraversalSource(None), PDsl.anon)
    for t, tp in zip(_chains(T), ported):
        jp = JI.compile_traversal(t)
        pp = PI.compile_traversal(tp)
        pp2 = PI.compile_steps(
            PDsl.Traversal._fold_has_into_start(list(t._steps)),
            max_depth=PI.DEFAULT_MAX_DEPTH)
        assert (jp is None) == (pp is None) == (pp2 is None), t._steps
        if pp is not None:
            same_plan(jp, pp)
            assert pp == pp2
            got += 1
        for depth in (1, 2, 6):
            a = JI.compile_steps(list(t._steps), depth)
            b = PI.compile_steps(list(t._steps), depth)
            assert (a is None) == (b is None)
            if b is not None:
                same_plan(a, b)
    g.rollback()
    assert got == 5


WIRE = [
    {"start": [7], "dir": "in", "hops": 2, "labels": ["knows"],
     "terminal": {"values": "name"}},
    {"start": 0},
    {"start": [1, 2, 3], "dir": "both", "hops": 4, "terminal": "count"},
    {"start": [5], "dir": "out", "hops": 2, "labels": [["a"], ["b", "c"]],
     "terminal": "id"},
    {"start": [5], "dir": "out", "hops": 2, "labels": [["a"], ["a"]]},
    {"start": [9], "hops": 9, "terminal": "count"},
    {"kind": "ppr", "source": 4},
    {"kind": "ppr", "source": 4, "iterations": 7, "damping": 0.5,
     "top_k": 3, "labels": ["x"], "directed": True,
     "include_source": True},
]

BAD_WIRE = [
    {"dir": "out"}, {"start": [1], "dir": "up"}, {"start": [1], "hops": 0},
    {"start": [1], "terminal": "paths"}, {"kind": "ppr"},
    {"kind": "ppr", "source": 1, "top_k": -1},
    {"kind": "ppr", "source": 1, "damping": 1.5},
    {"kind": "ppr", "source": 1, "iterations": 0},
    {"start": [1], "labels": "knows"},
    {"kind": "ppr", "source": 1, "labels": "x"},
    {"start": [1], "hops": 1 << 30}, {"kind": "walk", "start": [1]},
    {"start": [1], "hops": 3, "labels": [["a"], ["b"]]},
    {"start": [1], "hops": 2, "labels": [["a"], []]},
    {"start": []},
]


@pytest.mark.parametrize("i", range(len(WIRE)))
def test_plan_from_wire_equals_jax(i):
    same_plan(JI.plan_from_wire(WIRE[i]), PI.plan_from_wire(WIRE[i]))


@pytest.mark.parametrize("i", range(len(BAD_WIRE)))
def test_plan_from_wire_refuses_what_jax_refuses(i):
    with pytest.raises(ValueError) as jerr:
        JI.plan_from_wire(BAD_WIRE[i])
    with pytest.raises(ValueError) as perr:
        PI.plan_from_wire(BAD_WIRE[i])
    assert str(perr.value) == str(jerr.value)


def test_traversal_from_plan_builds_the_jax_chain(social):
    g = social[0]
    for body in WIRE[:5]:
        jt = JI.traversal_from_plan(JI.plan_from_wire(body), g.traversal())
        pt = PI.traversal_from_plan(PI.plan_from_wire(body), g.traversal())
        assert pt._steps == jt._steps
    g.rollback()


# -- collector -----------------------------------------------------------------

class _Plan:
    def __init__(self, key, i):
        self.key, self.i = key, i

    def fuse_key(self):
        return self.key


def _drain(col, reqs, pops):
    for r in reqs:
        col.submit(r)
    out = [[r.plan.i for r in col.pop_due().members] for _ in range(pops)]
    return out, col.depth()


def test_collector_groups_and_orders_like_jax():
    """Full groups flush first, in the order they filled; then the due
    pending groups; close() hands out what is left, then None."""
    keys = ["a", "b", "a", "c", "a", "b", "b", "a"]
    got = []
    for mod in (JCol, PCol):
        col = mod.Collector(window_s=0.0, max_fuse=3)
        reqs = [mod.InteractiveRequest(_Plan(k, i), "t")
                for i, k in enumerate(keys)]
        first, depth = _drain(col, reqs, 2)
        col.close()
        rest = []
        while (grp := col.pop_due()) is not None:
            rest.append(sorted(r.plan.i for r in grp.members))
        with pytest.raises(RuntimeError, match="closed"):
            col.submit(reqs[0])
        got.append((first, depth, sorted(rest), col.depth()))
    assert got[0] == got[1]
    assert got[1][0] == [[0, 2, 4], [1, 5, 6]]
    assert (PCol.DEFAULT_WINDOW_S, PCol.DEFAULT_MAX_FUSE) == \
        (JCol.DEFAULT_WINDOW_S, JCol.DEFAULT_MAX_FUSE)


def test_collector_holds_a_group_for_its_window():
    col = PCol.Collector(window_s=3600.0, max_fuse=4)
    r = PCol.InteractiveRequest(_Plan("a", 0), "t")
    col.submit(r)
    assert col.depth() == 1
    for i in range(1, 4):
        col.submit(PCol.InteractiveRequest(_Plan("a", i), "t"))
    grp = col.pop_due()                   # full: no wait for the window
    assert [m.plan.i for m in grp.members] == [0, 1, 2, 3]
    assert col.depth() == 0
    r.finish(result={"x": 1})
    assert r.wait(0) and r.result == {"x": 1}


# -- the lane on the n=192 shape ------------------------------------------------

@pytest.mark.parametrize("hops", [1, 2, 3, 4])
@pytest.mark.parametrize("dirname", ["out", "in", "both"])
def test_lane_equals_jax_and_the_expansion(shared, dirname, hops):
    (src, dst, labs), jsch, psch = shared
    seeds = [0, 5, 17, 100, 150, 191]
    bodies = [{"start": [x], "dir": dirname, "hops": hops,
               "terminal": "id" if i % 2 else "count"}
              for i, x in enumerate(seeds)]
    jr, pr = both_fused(jsch, psch, bodies)
    assert len({r["batch"] for r in pr}) == 1
    for x, b, j, p in zip(seeds, bodies, jr, pr):
        same_answer(j, p)
        assert p["fused_k"] == len(seeds)
        want = expand(src, dst, labs, [x], SWEPT[dirname], [None] * hops)
        if b["terminal"] == "count":
            assert p["result"] == len(want)
        else:
            assert sorted(p["result"]) == want.tolist()


def test_lane_mixed_depths_multistart_and_mixed_labels(shared):
    (src, dst, labs), jsch, psch = shared
    bodies = [{"start": [3, 40], "dir": "both", "hops": 3, "terminal": "id"},
              {"start": [9], "dir": "both", "hops": 1, "terminal": "id"},
              {"start": [99999], "dir": "both", "hops": 2,
               "terminal": "count"},
              {"start": [99999, 11], "dir": "both", "hops": 2,
               "terminal": "id"}]
    jr, pr = both_fused(jsch, psch, bodies)
    for b, j, p in zip(bodies, jr, pr):
        same_answer(j, p)
        known = [x for x in b["start"] if x < N]
        want = expand(src, dst, labs, known, SWEPT["both"],
                      [None] * b["hops"])
        got = p["result"]
        assert (len(want) if b["terminal"] == "count" else want.tolist()) \
            == (got if b["terminal"] == "count" else sorted(got))
    for dirname in ("out", "in", "both"):
        chain = [["a"], ["b", "c"], ["a", "c"]]
        bodies = [{"start": [x], "dir": dirname, "hops": 3,
                   "labels": chain, "terminal": "id"} for x in (2, 60, 77)]
        jr, pr = both_fused(jsch, psch, bodies)
        codes = [[0], [1, 2], [0, 2]]
        for x, j, p in zip((2, 60, 77), jr, pr):
            same_answer(j, p)
            assert sorted(p["result"]) == expand(
                src, dst, labs, [x], SWEPT[dirname], codes).tolist()
    # the per-hop masks are cached by device under the port's own name
    snap = psch.pool._fixed
    assert set(snap._hop_label_masks_by_device) == {CPU}
    assert getattr(jsch.pool._fixed, "_hop_label_masks", None) is not None


def test_single_label_chain_on_a_fixed_snapshot_sweeps_every_edge(shared):
    """The JAX pool leases its fixed snapshot before it looks at labels
    or ``directed``, so a single-label chain sweeps every edge, and
    ``both()`` on a directed graph sweeps one orientation; the port
    copies the reference (ROADMAP queue 3, item 5)."""
    (src, dst, labs), jsch, psch = shared
    bodies = [{"start": [x], "dir": "both", "hops": 1, "labels": lab,
               "terminal": "id"} for x in (4, 4, 4) for lab in (None, ["a"])]
    jr, pr = both_fused(jsch, psch, bodies)
    for j, p in zip(jr, pr):
        same_answer(j, p)
    assert sorted(pr[0]["result"]) == sorted(pr[1]["result"]) == \
        expand(src, dst, labs, [4], "in", [None]).tolist()
    assert sorted(pr[1]["result"]) != \
        expand(src, dst, labs, [4], "in", [[0]]).tolist()
    assert sorted(pr[0]["result"]) != \
        expand(src, dst, labs, [4], "both", [None]).tolist()


def test_lane_values_multistart_and_labels_on_the_social_graph(social):
    g, js, ps, jsch, psch = social
    ids = sorted(int(v) for v in js.vertex_ids)
    bodies = [{"start": [ids[2]], "dir": "out", "hops": 1,
               "terminal": {"values": "name"}},
              {"start": ids[:3], "dir": "out", "hops": 2,
               "terminal": {"values": "age"}},
              {"start": [ids[5]], "dir": "both", "hops": 2,
               "terminal": "count"},
              {"start": [999999], "dir": "out", "hops": 2,
               "terminal": "count"},
              {"start": [ids[1]], "dir": "out", "hops": 2,
               "labels": [["knows"], ["likes"]], "terminal": "id"},
              {"start": [ids[5]], "dir": "in", "hops": 3,
               "labels": [["likes"], ["knows"], ["likes"]],
               "terminal": {"values": "name"}},
              {"start": [ids[7]], "dir": "both", "hops": 2,
               "terminal": {"values": "nope"}}]
    for b in bodies:
        jr, pr = both_fused(jsch, psch, [b])
        if isinstance(jr[0], Exception):
            assert type(pr[0]).__name__ == type(jr[0]).__name__
            assert str(pr[0]) == str(jr[0])
            continue
        same_answer(jr[0], pr[0])


def test_lane_under_an_overlay_equals_jax_and_the_merged_epoch(shared):
    """``both`` chains over base + overlay equal the JAX lane's and the
    same chains on the compacted epoch; directed and mixed-label chains
    fall back loudly, as in JAX."""
    (src, dst, labs), _, _ = shared
    js = JS.from_arrays(N, np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
    ps = PS.from_numpy(js)
    jo = JaxOverlay(js, min_cap=64)
    po = DeltaOverlay(ps, min_cap=64, device="cpu")
    rng = np.random.default_rng(7)
    a_s = rng.integers(0, N, 40).astype(np.int32)
    a_d = rng.integers(0, N, 40).astype(np.int32)
    rm = rng.choice(M, 30, replace=False)
    for ov in (jo, po):
        ov.append_edges(np.concatenate([a_s, a_d]),
                        np.concatenate([a_d, a_s]), np.zeros(80, np.int32))
        for i in rm:
            assert ov.remove_edge(int(src[i]), int(dst[i]), None)
            assert ov.remove_edge(int(dst[i]), int(src[i]), None)
    jsch = JaxScheduler(snapshot=js, autostart=False)
    psch = JobScheduler(snapshot=ps, autostart=False, device="cpu")
    js._live_overlay, ps._live_overlay = jo.view(), po.view()
    seeds = [int(x) for x in rm[:4]] + [int(a_s[0]), int(a_d[1])]
    bodies = [{"start": [x], "dir": "both", "hops": h, "terminal": "id"}
              for x in seeds for h in (1, 3)]
    try:
        jr, pr = both_fused(jsch, psch, bodies)
        for j, p in zip(jr, pr):
            same_answer(j, p)
        for body, why in (({"dir": "out"}, "directed chain"),
                          ({"labels": [["a"], ["b"]]}, "mixed-label")):
            b = dict({"start": [seeds[0]], "dir": "both", "hops": 2,
                      "terminal": "id"}, **body)
            f0 = psch._metrics.counter_value("serving.interactive.fallbacks")
            jr2, pr2 = both_fused(jsch, psch, [b])
            assert isinstance(jr2[0], JI.FallbackToInterpreter)
            assert isinstance(pr2[0], PI.FallbackToInterpreter)
            assert why in str(pr2[0]) and str(pr2[0]) == str(jr2[0])
            assert psch._metrics.counter_value(
                "serving.interactive.fallbacks") == f0 + 1
    finally:
        jsch.close()
        psch.close()
    PH.build_chunked_csr(ps, "cpu")
    merged, mode = EpochCompactor(device="cpu").compact(ps, po)
    assert mode == "device"
    msch = JobScheduler(snapshot=merged, autostart=False, device="cpu")
    try:
        mr = run_fused(PI.InteractiveLane(msch, window_s=0.001,
                                          autostart=False),
                       [PI.plan_from_wire(b) for b in bodies])
    finally:
        msch.close()
    for p, m in zip(pr, mr):
        assert sorted(p["result"]) == sorted(m["result"])


def test_ppr_equals_jax_bit_for_bit(shared):
    _, jsch, psch = shared
    bodies = [{"kind": "ppr", "source": s, "iterations": 6, "top_k": 5}
              for s in (0, 7, 63, 191)]
    jr, pr = both_fused(jsch, psch, bodies)
    for j, p in zip(jr, pr):
        assert p["result"] == j["result"] and len(p["result"]) == 5
        assert (p["iterations"], p["fused_k"]) == (6, 4)
    assert psch._metrics.counter_value("serving.interactive.ppr_users") \
        >= 4
    jr, pr = both_fused(jsch, psch, [{"kind": "ppr", "source": 10 ** 9}])
    assert type(pr[0]) is type(jr[0]) is ValueError


# -- admission, tenants, metrics, lifecycle ------------------------------------

def span_names(tree) -> list:
    """A trace tree's span names, depth first."""
    out, todo = [], list(reversed(tree["spans"]))
    while todo:
        node = todo.pop()
        out.append(node["name"])
        todo.extend(reversed(node["children"]))
    return out


def test_depth_ceiling_quotas_tenants_and_metric_names():
    src, dst, labs = arrays(1)
    js = JS.from_arrays(N, src, dst)
    ps = PS.from_numpy(js)
    jsch = JaxScheduler(snapshot=js, autostart=False, enforce_quotas=True,
                        quotas={"flooder": JaxQuota(max_in_flight=0)},
                        metrics=JaxMetrics())
    psch = JobScheduler(snapshot=ps, autostart=False, device="cpu",
                        enforce_quotas=True,
                        quotas={"flooder": TenantQuota(max_in_flight=0)},
                        metrics=MetricManager())
    got = []
    try:
        for sch, I in ((jsch, JI), (psch, PI)):
            lane = I.InteractiveLane(sch, window_s=0.001, max_depth=2,
                                     autostart=False)
            deep = I.plan_from_wire({"start": [1], "hops": 3})
            with pytest.raises(I.FallbackToInterpreter, match="ceiling"):
                lane.submit(deep, tenant="team-a")
            quota_error = QuotaExceeded if I is PI else JaxQuotaExceeded
            with pytest.raises(quota_error, match="flooder"):
                lane.submit(I.plan_from_wire({"start": [1]}),
                            tenant="flooder")
            with pytest.raises(quota_error, match="flooder"):
                lane.account_fallback("flooder")
            done = lane.account_fallback("team-b")
            done()
            res = run_fused(lane, [I.plan_from_wire(
                {"start": [x], "dir": "both", "hops": 2,
                 "terminal": "count"}) for x in (1, 2, 3)],
                tenants=["team-a", "team-a", "team-b"])
            lane.close()                # joins the worker: its finally ran
            rows = sch.tenant_stats()["tenants"]
            m = sch._metrics
            names = sorted(k for k in m.snapshot()
                           if k.startswith("serving.interactive."))
            got.append({
                "res": [r["result"] for r in res],
                "a": rows["team-a"]["by_state"],
                "b": rows["team-b"]["by_state"],
                "flooder": rows["flooder"]["rejected"],
                "dev_s": rows["team-a"]["device_seconds"] > 0,
                "names": names,
                "fallbacks": m.counter_value("serving.interactive.fallbacks"),
                "batches": m.counter_value("serving.interactive.batches"),
                "requests": m.counter_value("serving.interactive.requests",
                                            labels={"tenant": "team-a"}),
                "rejected": m.counter_value("serving.tenant.rejected",
                                            labels={"tenant": "flooder"}),
                "fuse_k": m.histogram("serving.interactive.fuse_k").max,
                "stats": lane.stats(),
                "spans": span_names(sch.tracer.tree(res[0]["batch"]))})
    finally:
        jsch.close()
        psch.close()
    assert got[0] == got[1]
    assert got[1]["spans"][:2] == ["interactive", "fuse"]
    assert got[1]["fallbacks"] == 2 and got[1]["batches"] == 1
    assert got[1]["fuse_k"] == 3.0 and got[1]["dev_s"]


def test_scheduler_lane_configuration_close_and_eviction():
    src, dst, labs = arrays()
    ps = PS.from_arrays(N, src, dst, labels=labs, label_names=LABELS)
    s = JobScheduler(snapshot=ps, autostart=False, device="cpu",
                     interactive_window_s=0.25, interactive_max_fuse=5,
                     interactive_max_depth=3)
    lane = s.interactive()
    assert lane.stats() == {"queue_depth": 0, "window_s": 0.25,
                            "max_fuse": 5, "max_depth": 3}
    assert lane.device == CPU
    res = lane.submit(PI.plan_from_wire(
        {"start": [1], "dir": "out", "hops": 2,
         "labels": [["a"], ["b"]], "terminal": "id"}))
    assert res["fused_k"] == 1
    rev = ("interactive-rev", id(ps))
    assert s._evictable[rev] == (ps, "_hybrid_csr_rev_by_device")
    assert CPU in ps._hybrid_csr_rev_by_device
    assert CPU in ps._hop_label_masks_by_device
    assert s.ledger.resident_bytes() > 0 and s.ledger.pinned_bytes() == 0
    s._evict(rev)
    assert not hasattr(ps, "_hybrid_csr_rev_by_device")
    assert not hasattr(ps, "_hop_label_masks_by_device")
    lane.submit(PI.plan_from_wire({"start": [1], "dir": "both"}))
    assert CPU in ps._hybrid_csr_by_device
    s._evict(id(ps))
    assert not hasattr(ps, "_hybrid_csr_by_device")
    # the reversed layout is rebuilt on the next out() chain
    again = lane.submit(PI.plan_from_wire(
        {"start": [1], "dir": "out", "hops": 2,
         "labels": [["a"], ["b"]], "terminal": "id"}))
    assert sorted(again["result"]) == sorted(res["result"])
    s.close()
    assert lane.closed
    with pytest.raises(RuntimeError, match="closed"):
        lane.submit(PI.plan_from_wire({"start": [1]}))
    with pytest.raises(RuntimeError, match="closed"):
        s.interactive()


def test_lane_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    snap = PS.from_arrays(4, [0, 1], [1, 0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JobScheduler(snapshot=snap, autostart=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PComp.reversed_chunked_csr(snap)
