"""The port's queries (titan_tpu_torch/query/) against the JAX package's,
on the CPU: ``P`` on a grid of values and ops; ``GraphQuery`` on twin
graphs with composite indexes (cover, intersection, ``has_label``,
``order_by``, ``limit``, full scans, edges, a transaction's uncommitted
delta), equal by id and in order; ``vertex.query()`` on the graph of the
gods; the profiler's groups and annotations."""

import pytest

from titan_tpu.core.attribute import Geoshape as JGeo
from titan_tpu.core.defs import Direction as JD, Multiplicity as JMult
from titan_tpu.query import profile as JProf
from titan_tpu_torch.core.attribute import Geoshape as PGeo
from titan_tpu_torch.core.defs import Direction as PD, Multiplicity as PMult
from titan_tpu_torch.query import profile as PProf

from torch_twins import PKGS, canon, gods, open_twin

P_OF = {w: PKGS[w][2] for w in PKGS}
GEO = {"jax": JGeo, "port": PGeo}
DIR = {"jax": JD, "port": PD}
MULT = {"jax": JMult, "port": PMult}


# -- predicates ---------------------------------------------------------------

#: (op, arguments) built in each package; strings name a Geoshape maker
PREDICATES = [
    ("eq", (5,)), ("eq", ("a",)), ("neq", (5,)), ("lt", (5,)),
    ("lte", (5,)), ("gt", (5,)), ("gte", (5,)), ("between", (2, 7)),
    ("inside", (2, 7)), ("within", (1, 5, "a")), ("within", ([1, 5],)),
    ("without", (1, 5)), ("without", ({"a", "b"},)),
    ("text_contains", ("Quick fox",)), ("text_contains", ("",)),
    ("text_prefix", ("qu",)), ("text_regex", ("f.x",)),
    ("string_prefix", ("the",)), ("string_regex", ("t.*x",)),
    ("geo_within", ("box",)), ("geo_intersect", ("circle",)),
    ("geo_disjoint", ("box",)), ("geo_contains", ("point",)),
]


def shapes(geo):
    return {"box": geo.box(37.0, 22.0, 39.0, 24.0),
            "circle": geo.circle(38.0, 23.0, 50.0),
            "point": geo.point(38.1, 23.7)}


def candidates(geo, op: str):
    """The values a predicate is tried on: geoshapes for the geo ops
    (which read shape attributes), scalars of mixed types otherwise."""
    if op.startswith("geo_"):
        return [geo.point(38.1, 23.7), geo.point(10.0, 10.0),
                geo.circle(38.0, 23.0, 1.0), geo.circle(10.0, 10.0, 5.0),
                geo.box(37.5, 23.0, 38.5, 24.0)]
    return [None, 0, 1, 2, 5, 6.5, 7, 10, -3, "a", "b", "the quick fox",
            "The quick brown fox", "fax", "quack", "", True, 2 ** 40, [1]]


def build_p(which, op, args):
    P, geo = P_OF[which], shapes(GEO[which])
    if op.startswith("geo_"):
        args = (geo[args[0]],)
    return getattr(P, op)(*args)


@pytest.mark.parametrize("i", range(len(PREDICATES)))
def test_predicates_equal_jax_on_a_grid(i):
    op, args = PREDICATES[i]
    pj, pp = build_p("jax", op, args), build_p("port", op, args)
    assert pp.op == pj.op
    if not op.startswith("geo_"):
        assert repr(pp) == repr(pj) and pp.value == pj.value
    got = [pp(c) for c in candidates(PGeo, op)]
    assert got == [pj(c) for c in candidates(JGeo, op)]
    assert any(got) or op == "text_contains"


# -- graph-centric queries ----------------------------------------------------

def schema(g, which):
    m = g.management()
    mult = MULT[which]
    m.make_edge_label("knows", mult.MULTI)
    name = m.make_property_key("name", str)
    age = m.make_property_key("age", int)
    city = m.make_property_key("city", str)
    since = m.make_property_key("since", int)
    m.make_vertex_label("person")
    m.make_vertex_label("robot")
    m.build_index("by_name", "vertex").add_key(name) \
        .build_composite_index()
    m.build_index("by_city", "vertex").add_key(city) \
        .build_composite_index()
    m.build_index("by_age_city", "vertex").add_key(age).add_key(city) \
        .build_composite_index()
    m.build_index("by_since", "edge").add_key(since) \
        .build_composite_index()
    m.commit()


def city_graph(which):
    """30 vertices over 3 cities and 4 ages, 60 knows edges with a since
    in 0-4; then a second commit that moves one vertex's city and removes
    one vertex."""
    g = open_twin(which)
    schema(g, which)
    tx = g.new_transaction()
    vs = [tx.add_vertex("person" if i % 4 else "robot", name=f"v{i}",
                        age=20 + 10 * (i % 4), city=f"c{i % 3}")
          for i in range(30)]
    for k in range(60):
        a, b = (k * 7) % 30, (k * 11 + 3) % 30
        vs[a].add_edge("knows", vs[b], since=k % 5)
    tx.commit()
    tx = g.new_transaction()
    tx.vertex(vs[1].id).property("city", "c2")
    tx.vertex(vs[2].id).remove()
    tx.commit()
    return g


@pytest.fixture(scope="module")
def cities():
    out = {w: city_graph(w) for w in PKGS}
    yield out
    for g in out.values():
        g.close()


#: (name, query builder over (tx.query(), P), element)
QUERIES = [
    ("cover", lambda q, P: q.has("name", "v7"), "vertex"),
    ("cover_moved", lambda q, P: q.has("city", "c2"), "vertex"),
    ("two_key_cover", lambda q, P: q.has("city", "c0").has("age", 30),
     "vertex"),
    ("intersection", lambda q, P: q.has("name", "v9").has("city", "c0"),
     "vertex"),
    ("empty_intersection", lambda q, P: q.has("name", "v9")
     .has("city", "c1"), "vertex"),
    ("has_label", lambda q, P: q.has_label("robot").has("city", "c1"),
     "vertex"),
    ("order_limit", lambda q, P: q.has("city", "c1").order_by("age", "desc")
     .order_by("name").limit(4), "vertex"),
    ("order_asc", lambda q, P: q.has_label("person").order_by("name"),
     "vertex"),
    ("full_scan_gt", lambda q, P: q.has("age", P.gt(35)), "vertex"),
    ("full_scan_interval", lambda q, P: q.interval("age", 25, 45)
     .has("city", P.within("c0", "c2")), "vertex"),
    ("exists_absent", lambda q, P: q.has("city").has_not("nickname"),
     "vertex"),
    ("edge_cover", lambda q, P: q.has("since", 3), "edge"),
    ("edge_scan", lambda q, P: q.has("since", P.lt(2)).limit(7), "edge"),
]


def ids(elements) -> list:
    return [canon(e) for e in elements]


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_graph_query_equals_jax(cities, i):
    _, build, element = QUERIES[i]
    got = {}
    for which, g in cities.items():
        q = build(g.new_transaction().query(), P_OF[which])
        got[which] = ids(q.vertices() if element == "vertex"
                         else q.edges())
        if element == "vertex":
            assert build(g.query(), P_OF[which]).count() == len(got[which])
    assert got["port"] == got["jax"]


def test_graph_query_sees_the_transactions_delta(cities):
    """An uncommitted vertex and an uncommitted property change are seen
    by the indexed query of their own transaction, as in JAX."""
    got = {}
    for which, g in cities.items():
        tx = g.new_transaction()
        fresh = tx.add_vertex("person", name="fresh", age=99, city="c0")
        moved = next(iter(tx.query().has("name", "v4").vertices()))
        moved.property("city", "c0")
        a = ids(tx.query().has("city", "c0").vertices())
        b = ids(tx.query().has("name", "fresh").vertices())
        c = ids(tx.query().has("city", "c1").vertices())
        e = fresh.add_edge("knows", moved, since=3)
        d = ids(tx.query().has("since", 3).edges())
        assert canon(fresh) in a and canon(moved) in a
        assert b == [canon(fresh)] and canon(moved) not in c
        assert canon(e) in d
        got[which] = (a, b, c, d)
        tx.rollback()
    assert got["port"] == got["jax"]


def test_profiler_groups_and_annotations_equal_jax(cities):
    def strip(d):
        return {"name": d["name"], "annotations": d["annotations"],
                "children": [strip(c) for c in d["children"]]}
    got = {}
    for which, g in cities.items():
        prof_mod = JProf if which == "jax" else PProf
        P = P_OF[which]
        tree = []
        for build in (lambda q: q.has("name", "v7"),
                      lambda q: q.has("age", P.gt(35)),
                      lambda q: q.has("name", "v9").has("city", "c0")):
            root = prof_mod.QueryProfiler()
            build(g.new_transaction().query()).with_profiler(root) \
                .vertices()
            assert all(c.time_ns > 0 for c in root.children)
            tree.append((strip(root.to_dict()),
                         [line.split(" [")[0] for line in
                          root.render().splitlines()]))
        got[which] = tree
    assert got["port"] == got["jax"]
    assert [c["name"] for c in got["port"][0][0]["children"]] == \
        [PProf.OPTIMIZATION, PProf.BACKEND_QUERY]
    assert [c["name"] for c in got["port"][1][0]["children"]] == \
        [PProf.OPTIMIZATION, PProf.FULL_SCAN]


def test_no_op_profiler_and_traversal_metrics():
    for prof_mod in (JProf, PProf):
        assert prof_mod.NO_OP.group("x") is prof_mod.NO_OP
        with prof_mod.NO_OP as p:
            p.annotate("k", 1)
        assert prof_mod.NO_OP.annotations == {}
    steps = []
    for prof_mod in (JProf, PProf):
        a, b = prof_mod.StepMetrics("V"), prof_mod.StepMetrics("out")
        a.count, a.own_ns, b.count, b.own_ns = 3, 1_000_000, 9, 3_000_000
        m = prof_mod.TraversalMetrics([a, b], 4_000_000, compiled=True)
        steps.append((m.render(), m.total_ms, repr(m)))
        stage = prof_mod.TimedStage(iter([1, 2, 3]),
                                    prof_mod.StepMetrics("s"), None)
        assert list(stage) == [1, 2, 3] and stage.metrics.count == 3
        stage.finalize()
        assert stage.metrics.own_ns == stage.metrics.time_ns
    assert steps[1] == steps[0]


# -- vertex-centric queries ---------------------------------------------------

@pytest.fixture(scope="module")
def pantheon():
    out = {w: gods(w) for w in PKGS}
    yield out
    for g in out.values():
        g.close()


#: (name, builder over (vertex.query(), P, Direction), terminal)
VERTEX_QUERIES = [
    ("all_edges", lambda q, P, D: q, "edges"),
    ("labels_out", lambda q, P, D: q.labels("brother", "father")
     .direction(D.OUT), "edges"),
    ("labels_in", lambda q, P, D: q.labels("father").direction(D.IN),
     "vertices"),
    ("sort_key_interval", lambda q, P, D: q.labels("battled")
     .direction(D.OUT).interval("time", 1, 5), "edges"),
    ("interval_limit", lambda q, P, D: q.labels("battled")
     .interval("time", 0, 20).limit(2), "edges"),
    ("has_filter", lambda q, P, D: q.labels("battled", "lives")
     .has("time", P.gt(1)), "edges"),
    ("reason", lambda q, P, D: q.labels("lives").has("reason",
                                                     P.text_contains(
                                                         "breezes")),
     "vertices"),
    ("limit_both", lambda q, P, D: q.labels("brother").limit(3), "edges"),
    ("unknown_label", lambda q, P, D: q.labels("nope"), "edges"),
    ("properties", lambda q, P, D: q.labels("name", "age"), "properties"),
    ("count", lambda q, P, D: q.labels("brother").direction(D.OUT),
     "count"),
]


@pytest.mark.parametrize("i", range(len(VERTEX_QUERIES)))
def test_vertex_query_equals_jax(pantheon, i):
    _, build, terminal = VERTEX_QUERIES[i]
    got = {}
    for which, g in pantheon.items():
        tx = g.new_transaction()
        out = []
        for v in sorted(tx.vertices(), key=lambda v: v.id):
            q = build(v.query(), P_OF[which], DIR[which])
            r = getattr(q, terminal)()
            out.append(r if terminal == "count" else ids(r))
        got[which] = out
        tx.rollback()
    assert got["port"] == got["jax"]
    assert any(got["port"]) or VERTEX_QUERIES[i][0] == "unknown_label"


def test_vertex_query_sees_uncommitted_edges(pantheon):
    got = {}
    for which, g in pantheon.items():
        tx = g.new_transaction()
        herc = next(iter(tx.query().has("name", "hercules").vertices()))
        hydra = next(iter(tx.query().has("name", "hydra").vertices()))
        e = herc.add_edge("battled", hydra, time=3)
        q = herc.query().labels("battled").direction(DIR[which].OUT)
        got[which] = (ids(q.edges()), q.count())
        assert canon(e) in got[which][0]
        tx.rollback()
    assert got["port"] == got["jax"]
