"""``graph.compute(backend="gpu", device="cpu")`` on a port graph against
``graph.compute(backend="tpu")`` on the twin JAX-package graph (the same
seeded operations; the JAX computer on one device, as the engine tests
run it): BFS, WCC and SSSP exact, PageRank within rtol 1e-5 (float32
sums in another order). The computer's scheduler serves jobs over the
graph-backed pool, which leases one snapshot per label set and
orientation; a single-label chain of the interactive lane is held to a
label-filtered expansion of the edge list (ROADMAP queue 3, item 5)."""

import numpy as np
import pytest

import titan_tpu
import titan_tpu.models.bfs as jbfs
import titan_tpu.models.pagerank as jpr
import titan_tpu.models.sssp as jsssp
import titan_tpu.models.wcc as jwcc
import titan_tpu.olap.api as JA
import titan_tpu.utils.metrics as JM
import titan_tpu_torch
import titan_tpu_torch.models.bfs as pbfs
import titan_tpu_torch.models.pagerank as ppr
import titan_tpu_torch.models.sssp as psssp
import titan_tpu_torch.models.wcc as pwcc
import titan_tpu_torch.olap.api as PA
import titan_tpu_torch.utils.metrics as PM
from titan_tpu.ids.placement import SimpleBulkPlacement as JPlace
from titan_tpu_torch.device import INF
from titan_tpu_torch.ids.placement import SimpleBulkPlacement as PPlace
from titan_tpu_torch.models.bfs_hybrid import frontier_bfs_hybrid
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.serving.interactive import plan_from_wire

N, M, SEED = 60, 260, 5
RTOL = 1e-5
WAIT = 120


def populate(g, place, pairs, weights) -> list:
    g.id_assigner.placement = place(g.idm.num_partitions, batch_size=7,
                                    seed=SEED)
    m = g.management()
    m.make_property_key("weight", float)
    m.commit()
    tx = g.new_transaction()
    vs = [tx.add_vertex("node", name=f"v{i}") for i in range(N)]
    for k, ((a, b), w) in enumerate(zip(pairs, weights)):
        vs[a].add_edge("link" if k % 3 else "cite", vs[b], weight=w)
    tx.commit()
    return [v.id for v in vs]


@pytest.fixture(scope="module")
def twin():
    rng = np.random.default_rng(SEED)
    pairs = [(int(a), int(b)) for a, b in rng.integers(0, N, size=(M, 2))]
    weights = [float(x) for x in rng.uniform(0.5, 4.0, M)]
    gj, gp = titan_tpu.open("inmemory"), titan_tpu_torch.open("inmemory")
    vids = populate(gj, JPlace, pairs, weights)
    assert populate(gp, PPlace, pairs, weights) == vids
    jc = gj.compute(backend="tpu")
    jc.num_devices = 1
    pc = gp.compute(backend="gpu", device="cpu")
    yield {"jc": jc, "pc": pc, "gj": gj, "gp": gp, "vids": vids,
           "pairs": pairs}
    gj.close()
    gp.close()


def exact(a, b, key):
    assert a.iterations == b.iterations
    assert a[key].dtype == b[key].dtype
    np.testing.assert_array_equal(a[key], b[key])


def source(t) -> int:
    """The first vertex (an original id) with an out-edge."""
    return t["vids"][t["pairs"][0][0]]


def test_the_computer_is_built_from_the_graph(twin):
    pc = twin["pc"]
    assert type(pc).__name__ == "GPUGraphComputer" and pc.graph is twin["gp"]
    assert pc.device.type == "cpu"
    a = pc.snapshot()
    assert pc.snapshot() is a and pc.snapshot(directed=False) is not a
    assert pc.snapshot(labels=["cite"]) is pc.snapshot(labels=["cite"])
    assert a._graph is twin["gp"] and a.num_edges == M


def test_pagerank(twin):
    a, b = jpr.run(twin["jc"]), ppr.run(twin["pc"])
    assert a.iterations == b.iterations == 20
    np.testing.assert_allclose(b["rank"], a["rank"], rtol=RTOL)


def test_bfs(twin):
    exact(jbfs.run(twin["jc"], source(twin)),
          pbfs.run(twin["pc"], source(twin)), "dist")


def test_wcc(twin):
    exact(jwcc.run(twin["jc"]), pwcc.run(twin["pc"]), "label")


def test_sssp(twin):
    exact(jsssp.run(twin["jc"], source(twin)),
          psssp.run(twin["pc"], source(twin)), "dist")


def test_snapshots_equal_the_jax_computer_snapshots(twin):
    for kw in ({}, {"directed": False}, {"labels": ["link"]},
               {"edge_keys": ("weight",)}):
        a, b = twin["pc"].snapshot(**kw), twin["jc"].snapshot(**kw)
        for f in ("vertex_ids", "src", "dst", "indptr_in", "out_degree",
                  "labels"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (kw, f)


def serve(sched, specs):
    jobs = [sched.submit(s) for s in specs]
    sched.start()
    for j in jobs:
        assert j.wait(WAIT), j.state
    return jobs


@pytest.mark.parametrize("labels,directed", [
    (None, False), (["link"], False), (["cite"], True)])
def test_scheduler_leases_per_label_set_and_orientation(twin, labels,
                                                        directed):
    """BFS jobs through each computer's scheduler: the port's pool builds
    one snapshot per (labels, directed) from the graph, and each job's
    dist equals the JAX scheduler's and, on a symmetric lease (the
    bottom-up batched sweep's), a direct BFS on a snapshot built with the
    same parameters."""
    srcs = [twin["vids"][a] for a, _ in twin["pairs"][:3]]
    ps = PS.build(twin["gp"], labels=labels, directed=directed)
    out = {}
    for which, api, mm in (("jax", JA, JM), ("port", PA, PM)):
        c = twin["jc"] if which == "jax" else twin["pc"]
        c._scheduler = None
        sched = c.scheduler(hbm_budget_bytes=1e12, autostart=False,
                            metrics=mm.MetricManager())
        try:
            jobs = serve(sched, [api.JobSpec(
                kind="bfs", params={"source": s}, labels=labels,
                directed=directed) for s in srcs])
            out[which] = [j.result for j in jobs]
            if which == "port":
                st = sched.pool.stats()
                assert st["entries"] == 1 and st["active_leases"] == 0
                assert sched.pool.ready() == (True, "graph-backed "
                                                    "(1 resident)")
        finally:
            sched.close()
    for a, b, s in zip(out["jax"], out["port"], srcs):
        assert np.array_equal(a["dist"], b["dist"])
        assert a["levels"] == b["levels"] and a["reached"] == b["reached"]
        if not directed:      # the batched sweep is bottom-up: it needs
            d, _ = frontier_bfs_hybrid(ps, ps.dense_of(s), device="cpu")
            assert np.array_equal(b["dist"], np.minimum(d, INF))


def test_a_commit_refreshes_the_served_snapshot(twin):
    """After a commit the pool's next lease is refreshed: a job sees the
    new edge, and the pool still holds one snapshot."""
    gp, pc, vids = twin["gp"], twin["pc"], twin["vids"]
    pc._scheduler = None
    sched = pc.scheduler(hbm_budget_bytes=1e12, autostart=False,
                         metrics=PM.MetricManager())
    snap = PS.build(gp, labels=["cite"], directed=False)
    spec = PA.JobSpec(kind="bfs", params={"source": vids[0]},
                      labels=["cite"], directed=False)
    try:
        before = serve(sched, [spec])[0].result
        lonely = next(v for v in vids
                      if before["dist"][snap.dense_of(v)] >= INF)
        tx = gp.new_transaction()
        tx.vertex(vids[0]).add_edge("cite", tx.vertex(lonely))
        tx.commit()
        after = serve(sched, [spec])[0].result
        assert after["dist"][snap.dense_of(lonely)] == 1
        assert sched.pool.stats()["entries"] == 1
        tx = gp.new_transaction()
        for e in list(tx.vertex(vids[0]).out_edges("cite")):
            if e.in_vertex().id == lonely:
                e.remove()
        tx.commit()
    finally:
        sched.close()


def test_a_single_label_chain_is_label_filtered(twin):
    """On a graph-backed pool the lane leases a snapshot built for the
    chain's label, so out("link").out("link") follows link edges only."""
    pc = twin["pc"]
    pc._scheduler = None
    sched = pc.scheduler(hbm_budget_bytes=1e12, metrics=PM.MetricManager())
    try:
        lane = sched.interactive()
        link = [(a, b) for k, (a, b) in enumerate(twin["pairs"]) if k % 3]
        for x in sorted({a for a, _ in link})[:5]:
            frontier = {x}
            for _ in range(2):
                frontier = {b for a, b in link if a in frontier}
            got = lane.submit(plan_from_wire({
                "start": [twin["vids"][x]], "dir": "out", "hops": 2,
                "labels": ["link"], "terminal": "id"}))
            assert sorted(got["result"]) == \
                sorted(twin["vids"][v] for v in frontier)
    finally:
        sched.close()


def test_values_columns_attach_from_the_graph(twin):
    """A values() terminal on a graph-backed pool attaches the column
    from the graph on first use (olap/snapshot.attach_vertex_values)."""
    pc, vids, pairs = twin["pc"], twin["vids"], twin["pairs"]
    pc._scheduler = None
    sched = pc.scheduler(hbm_budget_bytes=1e12, metrics=PM.MetricManager())
    try:
        x = pairs[0][0]
        want = sorted(f"v{b}" for a, b in pairs if a == x)
        got = sched.interactive().submit(plan_from_wire({
            "start": [vids[x]], "dir": "out", "hops": 1,
            "terminal": {"values": "name"}}))
        assert sorted(got["result"]) == sorted(set(want))
    finally:
        sched.close()
