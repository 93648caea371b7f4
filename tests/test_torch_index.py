"""The port's mixed indexes on a graph against the JAX package's: the
``memindex`` and ``lucene`` (FTS5) providers behind ``build_mixed_index``,
the mixed cover of graph queries, ``index_query``, and the index lifecycle
with REINDEX and REMOVE_INDEX (``indexing/jobs.py``), each scenario of
``tests/test_index.py`` and ``tests/test_index_lifecycle.py`` on twin
graphs (seeded placement, so ids agree); hits exact as sets, and in order
where the JAX package orders them."""

import importlib
from types import SimpleNamespace

import pytest

from torch_twins import open_twin

ROOT = {"jax": "titan_tpu", "port": "titan_tpu_torch"}
BOTH = ("jax", "port")


def mod(which: str, name: str):
    return importlib.import_module(f"{ROOT[which]}.{name}")


def ns(which: str) -> SimpleNamespace:
    defs = mod(which, "core.defs")
    return SimpleNamespace(
        P=mod(which, "query.predicates").P,
        Geo=mod(which, "core.attribute").Geoshape,
        Action=defs.SchemaAction, Status=defs.SchemaStatus,
        errors=mod(which, "errors"), api=mod(which, "storage.api"),
        DataOutput=mod(which, "codec.dataio").DataOutput)


def config(kind: str, tmp_path, which: str) -> dict:
    if kind == "inmemory":
        return {"storage.backend": "inmemory",
                "index.search.backend": "memindex"}
    d = tmp_path / which
    return {"storage.backend": "sqlite",
            "storage.directory": str(d / "db"),
            "index.search.backend": "memindex" if kind == "sqlite"
            else "lucene",
            "index.search.directory": str(d / "idx")}


def run_both(scenario, kind="inmemory", tmp_path=None):
    """``scenario(which, graph, ns)`` on a twin graph in each package."""
    got = {}
    for which in BOTH:
        g = open_twin(which, config=config(kind, tmp_path, which))
        try:
            got[which] = scenario(which, g, ns(which))
        finally:
            g.close()
    assert got["port"] == got["jax"]
    return got["port"]


KINDS = ["inmemory", "sqlite", "sqlite+fts"]


def ids(vs) -> set:
    return {v.id for v in vs}


# -- mixed indexes on a graph ---------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_mixed_text_and_range(kind, tmp_path):
    def scen(which, g, n):
        mgmt = g.management()
        desc = mgmt.make_property_key("desc", str)
        age = mgmt.make_property_key("age2", int)
        idx = mgmt.build_index("search1", "vertex").add_key(desc, "TEXT") \
            .add_key(age).build_mixed_index("search")
        mgmt.commit()
        tx = g.new_transaction()
        v1 = tx.add_vertex(desc="the quick brown fox", age2=10)
        v2 = tx.add_vertex(desc="a lazy dog sleeps", age2=20)
        v3 = tx.add_vertex(desc="quick silver dog", age2=30)
        tx.commit()
        tx = g.new_transaction()
        a = ids(tx.query().has("desc", n.P.text_contains("quick"))
                .vertices())
        b = ids(tx.query().has("desc", n.P.text_contains("dog"))
                .has("age2", n.P.gt(25)).vertices())
        c = ids(tx.query().has("age2", n.P.between(10, 25)).vertices())
        tx.commit()
        assert (a, b, c) == ({v1.id, v3.id}, {v3.id}, {v1.id, v2.id})
        return (idx.name, idx.composite, idx.backing, idx.status.value,
                idx.key_params), sorted(a), sorted(b), sorted(c)
    run_both(scen, kind, tmp_path)


@pytest.mark.parametrize("kind", KINDS)
def test_mixed_updates_and_removal(kind, tmp_path):
    def scen(which, g, n):
        mgmt = g.management()
        bio = mgmt.make_property_key("bio", str)
        mgmt.build_index("search2", "vertex").add_key(bio, "TEXT") \
            .build_mixed_index("search")
        mgmt.commit()
        tx = g.new_transaction()
        v = tx.add_vertex(bio="loves graphs")
        tx.commit()
        tx = g.new_transaction()
        tx.vertex(v.id).property("bio", "loves tensors")
        tx.commit()
        tx = g.new_transaction()
        old = tx.query().has("bio", n.P.text_contains("graphs")).vertices()
        new = ids(tx.query().has("bio", n.P.text_contains("tensors"))
                  .vertices())
        tx.vertex(v.id).remove()
        tx.commit()
        tx = g.new_transaction()
        gone = tx.query().has("bio", n.P.text_contains("tensors")).vertices()
        tx.commit()
        return old, sorted(new) == [v.id], gone
    assert run_both(scen, kind, tmp_path) == ([], True, [])


@pytest.mark.parametrize("kind", KINDS)
def test_mixed_geo(kind, tmp_path):
    def scen(which, g, n):
        mgmt = g.management()
        place = mgmt.make_property_key("place", n.Geo)
        mgmt.build_index("geo1", "vertex").add_key(place) \
            .build_mixed_index("search")
        mgmt.commit()
        tx = g.new_transaction()
        sf = tx.add_vertex(place=n.Geo.point(37.77, -122.42))
        nyc = tx.add_vertex(place=n.Geo.point(40.71, -74.0))
        tx.commit()
        tx = g.new_transaction()
        bay = ids(tx.query().has("place", n.P.geo_within(
            n.Geo.circle(37.75, -122.4, 50))).vertices())
        box = ids(tx.query().has("place", n.P.geo_within(
            n.Geo.box(35.0, -125.0, 45.0, -70.0))).vertices())
        tx.commit()
        assert (bay, box) == ({sf.id}, {sf.id, nyc.id})
        return sorted(bay), sorted(box)
    run_both(scen, kind, tmp_path)


@pytest.mark.parametrize("kind", KINDS)
def test_raw_index_query(kind, tmp_path):
    """``index_query``: the same hits in the same order with the same
    scores (1.0 for memindex, sqlite's bm25 for FTS5)."""
    def scen(which, g, n):
        mgmt = g.management()
        text = mgmt.make_property_key("text", str)
        mgmt.build_index("search3", "vertex").add_key(text, "TEXT") \
            .build_mixed_index("search")
        mgmt.commit()
        tx = g.new_transaction()
        v = tx.add_vertex(text="hello world")
        tx.add_vertex(text="goodbye world")
        tx.add_vertex(text="hello hello there")
        tx.commit()
        hits = [(el.id, s) for el, s in g.index_query("search3",
                                                       "text:hello")]
        world = [(el.id, s) for el, s in g.index_query("search3", "world")]
        page = [(el.id, s) for el, s in g.index_query(
            "search3", "hello", limit=1, offset=1)]
        with pytest.raises(n.errors.TitanError, match="not a mixed index"):
            g.index_query("text", "x")
        assert v.id in {i for i, _ in hits} and len(world) == 2
        assert all(s > 0 for _, s in hits + world)
        return hits, world, page
    run_both(scen, kind, tmp_path)


def test_geo_predicate_on_missing_field():
    def scen(which, g, n):
        mgmt = g.management()
        place = mgmt.make_property_key("place", n.Geo)
        desc = mgmt.make_property_key("desc", str)
        mgmt.build_index("geo2", "vertex").add_key(place) \
            .add_key(desc, "TEXT").build_mixed_index("search")
        mgmt.commit()
        tx = g.new_transaction()
        tx.add_vertex(desc="no location here")
        v = tx.add_vertex(place=n.Geo.point(10.0, 10.0), desc="located")
        tx.commit()
        tx = g.new_transaction()
        hits = [h.id for h in tx.query().has("place", n.P.geo_within(
            n.Geo.circle(10.0, 10.0, 5))).vertices()]
        tx.commit()
        assert hits == [v.id]
        return hits
    run_both(scen)


def test_edge_composite_and_mixed_intersection():
    def scen(which, g, n):
        mgmt = g.management()
        since = mgmt.make_property_key("since", int)
        weight = mgmt.make_property_key("weight", float)
        mgmt.build_index("eSince", "edge").add_key(since) \
            .build_composite_index()
        mgmt.build_index("eWeight", "edge").add_key(weight) \
            .build_mixed_index("search")
        mgmt.commit()
        tx = g.new_transaction()
        a, b = tx.add_vertex(), tx.add_vertex()
        e1 = tx.add_edge(a, "knows", b, {"since": 1999, "weight": 0.9})
        tx.add_edge(b, "knows", a, {"since": 1999, "weight": 0.1})
        tx.commit()
        tx = g.new_transaction()
        hits = [h.id for h in tx.query().has("since", 1999)
                .has("weight", n.P.gt(0.5)).edges()]
        alone = [h.id for h in tx.query().has("weight", n.P.lt(0.5))
                 .edges()]
        tx.commit()
        assert hits == [e1.id] and len(alone) == 1
        return hits, alone
    run_both(scen)


def test_raw_query_on_edge_mixed_index():
    def scen(which, g, n):
        mgmt = g.management()
        note = mgmt.make_property_key("note", str)
        mgmt.build_index("eNotes", "edge").add_key(note, "TEXT") \
            .build_mixed_index("search")
        mgmt.commit()
        tx = g.new_transaction()
        a, b = tx.add_vertex(), tx.add_vertex()
        e = tx.add_edge(a, "rel", b, {"note": "important meeting"})
        tx.commit()
        hits = [(el.id, s) for el, s in g.index_query("eNotes",
                                                       "note:important")]
        assert hits == [(e.id, 1.0)]
        return hits
    run_both(scen)


def test_the_mixed_cover_shows_in_the_profile():
    """The profiler's groups: a mixed-covered query is OPTIMIZATION then
    BACKEND_QUERY with ``indexed`` true, a query the provider cannot
    answer is a full scan."""
    def scen(which, g, n):
        prof = mod(which, "query.profile")
        mgmt = g.management()
        mgmt.build_index("byName", "vertex").add_key(
            mgmt.make_property_key("name", str), "TEXT") \
            .build_mixed_index("search")
        mgmt.commit()
        tx = g.new_transaction()
        for i in range(30):
            tx.add_vertex("person", name=f"b{i}")
        tx.commit()
        out = []
        for pred in (n.P.text_prefix("b1"), n.P.eq("b3")):
            root = prof.QueryProfiler()
            tx = g.new_transaction(read_only=True)
            hits = sorted(v.id for v in tx.query().has("name", pred)
                          .with_profiler(root).vertices())
            tx.rollback()
            kids = root.to_dict()["children"]
            out.append((len(hits), [c["name"] for c in kids],
                        kids[0]["annotations"]))
        return out
    got = run_both(scen)
    assert got[0][0] == 11 and got[0][1][1] == "backend-query"
    assert got[0][2]["indexed"] is True
    assert got[1][0] == 1 and got[1][2]["indexed"] is False


def test_cluster_index_names_refuse_memindex_fallback():
    for which in BOTH:
        pkg = importlib.import_module(ROOT[which])
        for name in ("elasticsearch", "solr"):
            with pytest.raises(mod(which, "errors").ConfigurationError,
                               match="remote-index"):
                pkg.open({"storage.backend": "inmemory",
                          "index.search.backend": name})
        pkg.open({"storage.backend": "inmemory",
                  "index.search.backend": "memindex"}).close()


@pytest.mark.parametrize("backend", [
    "titan_tpu.indexing.memindex.MemoryIndex", "jax.Index"])
def test_a_jax_index_backend_is_refused_before_import(backend):
    import titan_tpu_torch
    with pytest.raises(ValueError, match="never imports"):
        titan_tpu_torch.open({"storage.backend": "inmemory",
                              "index.search.backend": backend})


def test_an_import_path_backend_opens_the_port_s_provider():
    got = {}
    for which in BOTH:
        g = importlib.import_module(ROOT[which]).open({
            "storage.backend": "inmemory",
            "index.search.backend":
                f"{ROOT[which]}.indexing.memindex.MemoryIndex"})
        try:
            p = g.index_provider("search")
            got[which] = (type(p).__name__, p.name,
                          type(p).__module__.split(".")[0])
        finally:
            g.close()
    assert got["port"][:2] == got["jax"][:2] == ("MemoryIndex", "search")
    assert got["port"][2] == "titan_tpu_torch"


def test_the_gods_with_mixed_indexes():
    """``example.load(mixed_index_name=)`` builds the gods' two mixed
    indexes (vertex age; edge reason and place) in both packages."""
    got = {}
    for which in BOTH:
        g = open_twin(which, config={"storage.backend": "inmemory",
                                     "index.search.backend": "memindex"})
        try:
            importlib.import_module(f"{ROOT[which]}.example").load(
                g, mixed_index_name="search")
            n = ns(which)
            tx = g.new_transaction()
            old = sorted(v.value("name") for v in tx.query().has(
                "age", n.P.gt(4000)).vertices())
            loves = sorted(e.id for e in tx.query().has(
                "reason", n.P.text_contains("loves")).edges())
            near = sorted(e.id for e in tx.query().has(
                "place", n.P.geo_within(n.Geo.circle(37.97, 23.72, 60)))
                .edges())
            tx.rollback()
            raw = sorted(el.id for el, _ in g.index_query(
                "edges", "reason:loves"))
            status = {ix: g.schema.get_by_name(ix).status.value
                      for ix in ("vertices", "edges")}
            got[which] = (old, loves, near, raw, status)
        finally:
            g.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["jupiter", "neptune", "saturn"]
    # the edge index holds only edges with both its keys (all keys
    # present): a battle has a place and no reason, a lives edge a reason
    # and no place, so the covered edge queries find none in either
    assert got["port"][1:4] == ([], [], [])
    assert got["port"][4] == {"vertices": "enabled", "edges": "enabled"}


# -- the lifecycle: REINDEX and REMOVE_INDEX -----------------------------------

def _seed(g, n=4):
    tx = g.new_transaction()
    out = [tx.add_vertex("person", name=f"p{i}", score=i).id
           for i in range(n)]
    tx.commit()
    return out


def _index_rows(g, n, idx) -> list:
    out = n.DataOutput()
    out.put_uvar(idx.id)
    prefix = out.getvalue()
    txh = g.backend.manager.begin_transaction()
    rows = sorted(k for k, es in g.backend.index_store.store.get_keys(
        n.api.SliceQuery(), txh) if k.startswith(prefix) and es)
    txh.commit()
    return rows


def test_register_reindex_enable():
    def scen(which, g, n):
        vids = _seed(g)
        mgmt = g.management()
        idx = mgmt.build_index("lateName", "vertex").add_key("name") \
            .build_composite_index()
        steps = [idx.status.value]
        mgmt.update_index(idx, n.Action.REGISTER_INDEX)
        steps.append(mgmt.get_graph_index("lateName").status.value)
        mgmt.update_index("lateName", n.Action.REINDEX)
        steps.append(mgmt.get_graph_index("lateName").status.value)
        mgmt.commit()
        tx = g.new_transaction()
        hits = [v.id for v in tx.query().has("name", "p2").vertices()]
        tx.commit()
        assert hits == [vids[2]]
        return steps, hits, _index_rows(g, n, idx)
    steps, _, rows = run_both(scen)
    assert steps == ["installed", "registered", "enabled"] and len(rows) == 4


@pytest.mark.parametrize("kind", KINDS)
def test_reindex_mixed(kind, tmp_path):
    def scen(which, g, n):
        _seed(g)
        mgmt = g.management()
        idx = mgmt.build_index("lateSearch", "vertex") \
            .add_key("name", "TEXT").build_mixed_index("search")
        before = idx.status.value
        mgmt.update_index(idx, n.Action.REGISTER_INDEX)
        mgmt.update_index(idx, n.Action.REINDEX)
        mgmt.commit()
        tx = g.new_transaction()
        hits = [v.value("name") for v in tx.query().has(
            "name", n.P.text_contains("p1")).vertices()]
        tx.commit()
        return before, g.schema.get_by_name("lateSearch").status.value, \
            hits, g.index_provider("search").count("lateSearch") \
            if hasattr(g.index_provider("search"), "count") else None
    assert run_both(scen, kind, tmp_path)[:3] == ("installed", "enabled",
                                                  ["p1"])


def test_disable_and_remove():
    def scen(which, g, n):
        mgmt = g.management()
        name = mgmt.make_property_key("name", str)
        idx = mgmt.build_index("n1", "vertex").add_key(name) \
            .build_composite_index()
        mgmt.commit()
        _seed(g)
        full = len(_index_rows(g, n, idx))
        mgmt = g.management()
        mgmt.update_index("n1", n.Action.DISABLE_INDEX)
        tx = g.new_transaction()
        scanned = len(tx.query().has("name", "p1").vertices())
        tx.commit()
        mgmt.update_index("n1", n.Action.REMOVE_INDEX)
        return full, scanned, _index_rows(g, n, idx)
    assert run_both(scen) == (4, 1, [])


def test_remove_a_mixed_index_drops_its_documents():
    def scen(which, g, n):
        _seed(g)
        mgmt = g.management()
        mgmt.build_index("m1", "vertex").add_key("name", "TEXT") \
            .build_mixed_index("search")
        mgmt.update_index("m1", n.Action.REGISTER_INDEX)
        mgmt.update_index("m1", n.Action.REINDEX)
        p = g.index_provider("search")
        before = p.count("m1")
        mgmt.update_index("m1", n.Action.DISABLE_INDEX)
        mgmt.update_index("m1", n.Action.REMOVE_INDEX)
        mgmt.commit()
        return before, p.count("m1")
    assert run_both(scen) == (4, 0)


def test_illegal_transition():
    def scen(which, g, n):
        mgmt = g.management()
        name = mgmt.make_property_key("name", str)
        mgmt.build_index("n2", "vertex").add_key(name) \
            .build_composite_index()
        mgmt.commit()
        out = []
        for action in (n.Action.REGISTER_INDEX, n.Action.REMOVE_INDEX):
            with pytest.raises(n.errors.TitanError) as exc:
                mgmt.update_index("n2", action)
            out.append(str(exc.value))
        return out
    run_both(scen)


def test_installed_index_receives_no_writes():
    def scen(which, g, n):
        _seed(g, 1)
        mgmt = g.management()
        idx = mgmt.build_index("cold", "vertex").add_key("name") \
            .build_composite_index()
        mgmt.commit()
        tx = g.new_transaction()
        tx.add_vertex(name="newbie")
        tx.commit()
        return idx.status.value, _index_rows(g, n, idx)
    assert run_both(scen) == ("installed", [])


def test_memindex_keyinfo_survives_reopen(tmp_path):
    got = {}
    for which in BOTH:
        cfg = config("sqlite", tmp_path, which)
        g = open_twin(which, config=dict(cfg))
        mgmt = g.management()
        code = mgmt.make_property_key("code", str)
        mgmt.build_index("codes", "vertex").add_key(code, "STRING") \
            .build_mixed_index("search")
        mgmt.commit()
        tx = g.new_transaction()
        v = tx.add_vertex(code="alpha beta")
        tx.commit()
        g.close()
        g = importlib.import_module(ROOT[which]).open(dict(cfg))
        tx = g.new_transaction()
        hits = [x.id for x in tx.query().has("code", "alpha beta")
                .vertices()]
        info = g.index_provider("search")._stores["codes"].keyinfo["code"]
        tx.commit()
        g.close()
        assert hits == [v.id]
        got[which] = (hits, info.parameters, info.dtype.__name__,
                      info.cardinality.value)
    assert got["port"] == got["jax"]
    assert got["port"][1] == ("STRING",)
