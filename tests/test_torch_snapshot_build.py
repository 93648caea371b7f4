"""The port's snapshot build from a graph (titan_tpu_torch/olap/snapshot.py
``build``, ``refresh``, ``rebuild_in_place``, ``apply_changes``,
``attach_vertex_values``, ``stale``, ``close``) held field by field to
``titan_tpu.olap.tpu.snapshot`` on a twin graph: the same seeded
operations on a JAX-package graph and a port graph
(tests/test_snapshot_refresh.py has the JAX package's own shapes)."""

import gc
import threading

import numpy as np
import pytest

import titan_tpu
import titan_tpu_torch
from titan_tpu.ids.placement import SimpleBulkPlacement as JPlace
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu_torch.ids.placement import SimpleBulkPlacement as PPlace
from titan_tpu_torch.models.bfs_hybrid import build_chunked_csr
from titan_tpu_torch.olap import engine as PE
from titan_tpu_torch.olap import snapshot as PS

FIELDS = ("n", "vertex_ids", "src", "dst", "indptr_in", "out_degree",
          "labels", "label_names", "epoch")


def same(ps, js) -> None:
    for f in FIELDS:
        a, b = getattr(ps, f), getattr(js, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f
    assert ps.edge_values.keys() == js.edge_values.keys()
    for k, v in js.edge_values.items():
        assert np.array_equal(ps.edge_values[k], v), k
    assert ps.stale == js.stale


class Twin:
    """The same graph in both packages, changed by the same calls."""

    def __init__(self, seed: int = 3, n: int = 12, m: int = 30):
        self.g = {"jax": titan_tpu.open("inmemory"),
                  "port": titan_tpu_torch.open("inmemory")}
        for which, place in (("jax", JPlace), ("port", PPlace)):
            g = self.g[which]
            g.id_assigner.placement = place(g.idm.num_partitions,
                                            batch_size=4, seed=seed)
            mg = g.management()
            mg.make_property_key("w", int)
            mg.make_property_key("tag", str)
            mg.commit()
        rng = np.random.default_rng(seed)
        self.pairs = [(int(a), int(b)) for a, b in
                      rng.integers(0, n, size=(m, 2))]
        self.vids = self.each(self._populate, n)

    def _populate(self, g, n):
        tx = g.new_transaction()
        vs = [tx.add_vertex("node", name=f"v{i}",
                            **({"tag": f"t{i % 3}"} if i % 2 else {}))
              for i in range(n)]
        for k, (a, b) in enumerate(self.pairs):
            vs[a].add_edge("link" if k % 3 else "cite", vs[b], w=k)
        tx.commit()
        return [v.id for v in vs]

    def each(self, fn, *args):
        out = [fn(self.g[w], *args) for w in ("jax", "port")]
        if not isinstance(out[0], (JS.GraphSnapshot, PS.GraphSnapshot)):
            assert out[0] == out[1]
        return out[1]

    def commit(self, fn) -> None:
        def go(g):
            tx = g.new_transaction()
            fn(tx, self.vids)
            tx.commit()
        self.each(go)
        assert self.g["jax"].mutation_epoch == self.g["port"].mutation_epoch

    def build(self, **kw):
        return (PS.build(self.g["port"], **kw), JS.build(self.g["jax"], **kw))

    def close(self):
        for g in self.g.values():
            g.close()


@pytest.fixture
def twin():
    t = Twin()
    yield t
    t.close()


@pytest.mark.parametrize("kw", [
    {}, {"directed": False}, {"labels": ["link"]},
    {"labels": ["cite"], "directed": False}, {"labels": ["nope"]},
    {"edge_keys": ["w"]}, {"edge_keys": ["w"], "labels": ["link"],
                           "directed": False}],
    ids=["all", "undirected", "label", "label-undirected", "unknown-label",
         "edge_keys", "edge_keys-label-undirected"])
def test_build_equals_the_jax_build(twin, kw):
    ps, js = twin.build(**kw)
    same(ps, js)
    assert ps._build_params == js._build_params
    assert ps.epoch == twin.g["port"].mutation_epoch


def test_the_three_scans_agree(twin, monkeypatch):
    """The packed native scan (the in-memory store), the entry-wise
    native scan (a store without packed ops) and the Python codec
    (edge_keys) give the same arrays."""
    packed, _ = twin.build()
    python, _ = twin.build(edge_keys=["w"])
    feats = twin.g["port"].backend.manager.features
    monkeypatch.setattr(type(twin.g["port"].backend.manager), "features",
                        property(lambda self: type(feats)(
                            **{**feats.__dict__, "packed_ops": False})))
    calls = []
    real = PS._scan_native
    monkeypatch.setattr(PS, "_scan_native",
                        lambda *a: calls.append(1) or real(*a))
    entrywise = PS.build(twin.g["port"])
    assert calls == [1]
    for f in FIELDS:
        a = getattr(packed, f)
        for b in (getattr(python, f), getattr(entrywise, f)):
            assert np.array_equal(a, b) if isinstance(a, np.ndarray) \
                else a == b, f


@pytest.mark.parametrize("make,path", [
    pytest.param(lambda r: (np.arange(1000, dtype=np.int64) + 7) << 8 | 3,
                 "table", id="dense"),
    pytest.param(lambda r: np.unique(r.integers(1, 1 << 40, 1000)),
                 "search", id="sparse"),
    pytest.param(lambda r: np.sort(np.repeat(r.integers(1, 1 << 20, 500),
                                             2)), "search", id="repeated"),
    pytest.param(lambda r: np.array([42], np.int64), "search", id="one")])
def test_dense_index_finds_every_member(make, path, monkeypatch):
    """``build``'s id lookup: a member's index equals np.searchsorted's
    and a ghost never matches, on the table path and on the fallback."""
    rng = np.random.default_rng(0)
    ids = make(rng)
    ghosts = np.array([0, -5, 17, 1 << 50, int(ids[-1]) + 1], np.int64)
    ghosts = ghosts[~np.isin(ghosts, ids)]
    raw = rng.permutation(np.concatenate(
        [ids[rng.integers(0, len(ids), 5000)], ghosts]))
    calls = []
    real = np.searchsorted
    monkeypatch.setattr(np, "searchsorted",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = PS._dense_index(ids, raw)
    monkeypatch.undo()
    assert bool(calls) == (path == "search")
    member = np.isin(raw, ids)
    assert np.array_equal(got[member],
                          np.searchsorted(ids, raw)[member])
    got = np.clip(got, 0, len(ids) - 1)
    assert not (ids[got[~member]] == raw[~member]).any()


def test_removed_vertices_and_edges(twin):
    def change(tx, vids):
        tx.vertex(vids[2]).remove()
        for e in list(tx.vertex(vids[5]).out_edges("link"))[:1]:
            e.remove()
    twin.commit(change)
    for kw in ({}, {"directed": False}):
        same(*twin.build(**kw))


@pytest.mark.parametrize("directed", [True, False])
def test_refresh_after_commits_equals_the_jax_refresh(twin, directed):
    ps, js = twin.build(directed=directed)
    steps = [
        # new edges between existing vertices: the merge fast path
        lambda tx, v: tx.vertex(v[0]).add_edge("link", tx.vertex(v[7])),
        # a new vertex with an edge, and an old edge removed
        lambda tx, v: (tx.vertex(v[3]).add_edge(
            "cite", tx.add_vertex("node", name="new")),
            [e.remove() for e in list(tx.vertex(v[1]).out_edges())[:1]]),
        # a removed vertex, an edge to it added before
        lambda tx, v: tx.vertex(v[4]).remove(),
        # a property change only
        lambda tx, v: tx.vertex(v[6]).property("tag", "x"),
    ]
    for step in steps:
        twin.commit(step)
        assert ps.stale and js.stale
        stats = ps.refresh()
        assert stats == js.refresh()
        same(ps, js)
        assert not ps.stale
    fresh, _ = twin.build(directed=directed)
    for f in ("vertex_ids", "indptr_in", "out_degree"):
        assert np.array_equal(getattr(ps, f), getattr(fresh, f))


def test_refresh_drops_the_port_caches(twin):
    ps, _ = twin.build(directed=False)
    build_chunked_csr(ps, "cpu")
    PE.device_graph(ps, "cpu")
    ps.out_csr()
    ps._hybrid_csr_rev_by_device["cpu"] = object()
    ps._hop_label_masks_by_device["cpu"] = {}
    assert ps._hybrid_csr_by_device and ps._device_graphs
    twin.commit(lambda tx, v: tx.vertex(v[0]).add_edge("link",
                                                      tx.vertex(v[1])))
    ps.refresh()
    assert ps._out_csr is None and ps._out_csr_order is None
    for attr in PS.GraphSnapshot._DEVICE_CACHES:
        assert getattr(ps, attr) == {}, attr
    # and the next use rebuilds from the refreshed arrays
    g = build_chunked_csr(ps, "cpu")
    assert int(g["deg"][:ps.n].sum()) == ps.num_edges


def test_a_commit_from_another_thread_during_the_scan_is_retried(
        twin, monkeypatch):
    """build() sees the epoch move during its scan and scans again; when
    writers race two scans, the third scans under the commit lock."""
    g = twin.g["port"]
    real = PS._scan_native_packed
    calls = []

    def racing(*a):
        calls.append(1)
        if len(calls) <= 2:
            def commit():
                tx = g.new_transaction()
                tx.vertex(twin.vids[0]).add_edge("link",
                                                 tx.vertex(twin.vids[9]))
                tx.commit()
            t = threading.Thread(target=commit)
            t.start()
            t.join(30)
            assert not t.is_alive()
        return real(*a)

    monkeypatch.setattr(PS, "_scan_native_packed", racing)
    e0 = g.mutation_epoch
    snap = PS.build(g)
    assert len(calls) == 3 and g.mutation_epoch == e0 + 2
    assert snap.epoch == g.mutation_epoch and not snap.stale
    pair = (twin.vids[0], twin.vids[9])
    got = [(int(snap.vertex_ids[s]), int(snap.vertex_ids[d]))
           for s, d in zip(snap.src, snap.dst)]
    assert got.count(pair) == sum(p == (0, 9) for p in twin.pairs) + 2


def test_rebuild_in_place_after_an_overflow(twin):
    ps, js = twin.build()
    q = ps._listener
    for s in (ps, js):
        s._listener.overflowed = True
    twin.commit(lambda tx, v: tx.vertex(v[0]).add_edge("link",
                                                      tx.vertex(v[1])))
    for s in (ps, js):
        with pytest.raises(RuntimeError, match="overflow"):
            s.refresh()
        s.rebuild_in_place()
    same(ps, js)
    assert ps._listener is q and not q.overflowed
    twin.commit(lambda tx, v: tx.vertex(v[1]).add_edge("cite",
                                                      tx.vertex(v[2])))
    assert ps.refresh() == js.refresh() == {
        "added_edges": 1, "removed_edges": 0, "added_vertices": 0,
        "removed_vertices": 0}
    same(ps, js)


def test_refresh_refusals_equal_the_jax_refusals(twin):
    ps, js = twin.build()
    twin.commit(lambda tx, v: tx.vertex(v[0]).add_edge("link",
                                                      tx.vertex(v[1])))
    for s in (ps, js):
        s._listener.pop(0)                    # a missed commit
        with pytest.raises(RuntimeError, match="gap"):
            s.refresh()
    ps, js = twin.build(edge_keys=["w"])
    twin.commit(lambda tx, v: tx.vertex(v[0]).add_edge("link",
                                                      tx.vertex(v[1])))
    for s in (ps, js):
        with pytest.raises(NotImplementedError, match="edge_values"):
            s.refresh()


def test_attach_vertex_values_equals_the_jax_columns(twin):
    ps, js = twin.build()
    for s, g in ((ps, twin.g["port"]), (js, twin.g["jax"])):
        s.attach_vertex_values(g, ["tag", "name", "missing"])
    for k in ("tag", "name", "missing"):
        (pv, pp), (jv, jp) = ps.vertex_values[k], js.vertex_values[k]
        assert np.array_equal(pp, jp) and list(pv[pp]) == list(jv[jp]), k
    # a property change drops its column, an edge-only change keeps it
    twin.commit(lambda tx, v: tx.vertex(v[1]).property("tag", "y"))
    ps.refresh()
    assert "tag" not in ps.vertex_values and "name" in ps.vertex_values


def test_stale_and_close(twin):
    g = twin.g["port"]
    ps, _ = twin.build()
    assert not ps.stale and len(g._change_listeners) >= 1
    twin.commit(lambda tx, v: tx.vertex(v[0]).add_edge("link",
                                                      tx.vertex(v[1])))
    assert ps.stale
    n0 = len(g._change_listeners)
    ps.close()
    assert len(g._change_listeners) == n0 - 1 and not ps.stale
    with pytest.raises(RuntimeError, match="no source graph"):
        ps.refresh()
    arr = PS.from_arrays(3, [0, 1], [1, 2])
    assert not arr.stale
    with pytest.raises(RuntimeError, match="no source graph"):
        arr.rebuild_in_place()
    # a dropped snapshot unregisters its listener (held weakly)
    ps2, _ = twin.build()
    n1 = len(g._change_listeners)
    del ps2
    gc.collect()
    assert len(g._change_listeners) == n1 - 1


@pytest.mark.parametrize("directed", [True, False])
def test_refresh_removes_parallel_edges_like_the_jax_refresh(directed):
    """Removals among parallel edges and self-loops drop the same rows as
    the JAX refresh (the first matching rows, one a removed relation and
    direction), and equal a fresh build's CSR."""
    t = Twin(seed=8, n=6, m=40)          # many parallel edges
    try:
        ps, js = t.build(directed=directed)

        def change(tx, vids):
            for v in vids[:3]:
                for e in list(tx.vertex(v).out_edges())[::2]:
                    e.remove()
            tx.vertex(vids[4]).add_edge("link", tx.vertex(vids[4]))
        t.commit(change)
        assert ps.refresh() == js.refresh()
        same(ps, js)
        fresh, _ = t.build(directed=directed)
        for f in ("vertex_ids", "indptr_in", "out_degree"):
            assert np.array_equal(getattr(ps, f), getattr(fresh, f)), f
    finally:
        t.close()


def test_one_refresh_over_an_add_then_a_removal_of_its_vertex(twin):
    """Commit A adds edges to a vertex and a new one, commit B removes
    the vertex; one refresh drops A's edge to it, as the JAX refresh
    and a fresh build do."""
    ps, js = twin.build(directed=False)
    twin.commit(lambda tx, v: (
        tx.vertex(v[5]).add_edge("link", tx.vertex(v[2])),
        tx.vertex(v[2]).add_edge("cite", tx.add_vertex("node", name="w"))))
    twin.commit(lambda tx, v: tx.vertex(v[2]).remove())
    assert ps.refresh() == js.refresh()
    same(ps, js)
    fresh, _ = twin.build(directed=False)
    for f in ("vertex_ids", "indptr_in", "out_degree"):
        assert np.array_equal(getattr(ps, f), getattr(fresh, f)), f
