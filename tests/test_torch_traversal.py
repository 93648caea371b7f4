"""The port's traversal DSL (titan_tpu_torch/traversal/dsl.py) against the
JAX package's, on the CPU.

Every step of the catalogue (``titan_tpu/traversal/dsl.py:23-30``) runs on
the two packages' graphs of the gods and on a seeded property graph,
built as twins (tests/torch_twins.py), with bulking on and off
(``TITAN_TPU_NO_BULK``); the outputs compare in canonical form (elements
by id, values, dicts as sorted pairs) and in order. Misused modulators
and patterns raise as in JAX. A seeded differential run holds the port's
interpreter to the independent TP3 oracle (tests/tp3_oracle.py), as
tests/test_tp3_differential.py holds JAX's."""

import operator
import random

import pytest

import titan_tpu_torch
from titan_tpu_torch.query.predicates import P as PP
from titan_tpu_torch.traversal import dsl as PDsl

import tp3_oracle
from test_tp3_differential import E_LABELS, V_LABELS, canon_oracle, gen_spec
from torch_twins import PKGS, canon, gods, people


@pytest.fixture(scope="module")
def pantheon():
    out = {w: gods(w) for w in PKGS}
    yield out
    for g in out.values():
        g.close()


def ids_by_name(g) -> dict:
    return {v.value("name"): v.id for v in g.traversal().V().to_list()}


#: the catalogue on the gods, as builders of (source, P, anon, ids by name)
GODS = {
    "V_count": lambda g, P, A, I: g.V().count(),
    "V_ids": lambda g, P, A, I: g.V(I["pluto"], I["sky"], I["pluto"])
    .values("name"),
    "E_label": lambda g, P, A, I: g.E().label(),
    "E_count": lambda g, P, A, I: g.E().count(),
    "has_values": lambda g, P, A, I: g.V().has("name", "hercules")
    .values("age"),
    "has_pred": lambda g, P, A, I: g.V().has("age", P.between(30, 5000))
    .values("name"),
    "has_key": lambda g, P, A, I: g.V().has("age").values("name"),
    "has_label": lambda g, P, A, I: g.V().has_label("god", "titan")
    .values("name"),
    "has_id": lambda g, P, A, I: g.V().has_id(I["pluto"], I["sea"])
    .has_id(I["sea"]).values("name"),
    "has_pseudo": lambda g, P, A, I: g.V().has("label", "monster")
    .has("id", P.neq(I["hydra"])).values("name"),
    "out_labels": lambda g, P, A, I: g.V().has("name", "hercules")
    .out("father", "mother").values("name"),
    "in": lambda g, P, A, I: g.V().has("name", "jupiter").in_("brother")
    .values("name"),
    "both": lambda g, P, A, I: g.V().has("name", "pluto").both()
    .values("name"),
    "out_count": lambda g, P, A, I: g.V().out().count(),
    "both_e_count": lambda g, P, A, I: g.V().both_e().count(),
    "outE_inV": lambda g, P, A, I: g.V().has("name", "hercules")
    .out_e("battled").has("time", P.gt(1)).in_v().values("name"),
    "inE_outV": lambda g, P, A, I: g.V().has("name", "tartarus")
    .in_e("lives").out_v().values("name"),
    "bothE_otherV": lambda g, P, A, I: g.V().has("name", "jupiter")
    .both_e().other_v().values("name"),
    "edge_values": lambda g, P, A, I: g.V().out_e("lives").values("reason"),
    "edge_place": lambda g, P, A, I: g.V().out_e("battled")
    .values("place"),
    "properties": lambda g, P, A, I: g.V().has("name", "saturn")
    .properties(),
    "properties_key": lambda g, P, A, I: g.V().properties("age").count(),
    "value_map": lambda g, P, A, I: g.V().has_label("god")
    .value_map("name", "age"),
    "edge_value_map": lambda g, P, A, I: g.V().has("name", "hercules")
    .out_e("battled").value_map(),
    "id_label": lambda g, P, A, I: g.V().out("lives").label(),
    "ids": lambda g, P, A, I: g.V().has_label("monster").id_(),
    "limit": lambda g, P, A, I: g.V().out().limit(4).values("name"),
    "limit_zero": lambda g, P, A, I: g.V().limit(0),
    "dedup": lambda g, P, A, I: g.V().out().dedup().values("name"),
    "dedup_by": lambda g, P, A, I: g.V().dedup().by("age").count(),
    "order_by_desc": lambda g, P, A, I: g.V().has_label("god").order()
    .by("age", desc=True).values("name"),
    "order_values": lambda g, P, A, I: g.V().values("age").order(desc=True),
    "order_two_keys": lambda g, P, A, I: g.V().has("age").order()
    .by(lambda v: v.label()).by("age", desc=True).values("name"),
    "where_sub": lambda g, P, A, I: g.V().where(A().out("battled"))
    .values("name"),
    "where_fn": lambda g, P, A, I: g.V().where(
        lambda v: (v.value("age") or 0) > 100).values("name"),
    "filter": lambda g, P, A, I: g.V().filter_(
        lambda v: v.label() == "monster").values("name"),
    "not": lambda g, P, A, I: g.V().has_label("god").not_(A().out("pet"))
    .values("name"),
    "and": lambda g, P, A, I: g.V().and_(A().out("brother"),
                                         A().out("lives")).values("name"),
    "or": lambda g, P, A, I: g.V().or_(A().has_label("titan"),
                                       A().has("age", P.lt(100)))
    .values("name"),
    "repeat_times": lambda g, P, A, I: g.V().has("name", "hercules")
    .repeat(A().out("father")).times(2).values("name"),
    "repeat_until": lambda g, P, A, I: g.V().has("name", "hercules")
    .repeat(A().out("father")).until(A().has("name", "saturn")).path(),
    "repeat_emit": lambda g, P, A, I: g.V().has("name", "hercules")
    .repeat(A().out("father")).times(2).emit().values("name"),
    "until_repeat": lambda g, P, A, I: g.V().has("name", "hercules")
    .until(A().has_label("titan")).repeat(A().out("father"))
    .values("name"),
    "emit_repeat": lambda g, P, A, I: g.V().has("name", "hercules").emit()
    .repeat(A().out("father")).times(2).values("name"),
    "repeat_both_count": lambda g, P, A, I: g.V()
    .repeat(A().both()).times(3).count(),
    "bare_repeat": lambda g, P, A, I: g.V().has("name", "pluto")
    .repeat(A().out("brother")).values("name"),
    "simple_path": lambda g, P, A, I: g.V().has("name", "jupiter")
    .both("brother").both("brother").simple_path().path(),
    "path": lambda g, P, A, I: g.V().has("name", "hercules")
    .out("battled").path(),
    "as_select": lambda g, P, A, I: g.V().as_("a").out("father").as_("b")
    .select("a", "b"),
    "select_by": lambda g, P, A, I: g.V().as_("a").out("father").as_("b")
    .select("a", "b").by("name").by("age"),
    "select_one": lambda g, P, A, I: g.V().as_("a").out("lives")
    .select("a").values("name"),
    "union": lambda g, P, A, I: g.V().has("name", "jupiter")
    .union(A().out("lives"), A().in_("father")).values("name"),
    "coalesce": lambda g, P, A, I: g.V().has_label("god")
    .coalesce(A().out("pet"), A().out("lives")).values("name"),
    "choose_if": lambda g, P, A, I: g.V().has_label("god")
    .choose(A().out("pet"), A().out("pet"), A().out("lives"))
    .values("name"),
    "choose_option": lambda g, P, A, I: g.V()
    .choose(lambda v: v.label()).option("god", A().values("age"))
    .option("monster", A().constant("m")).option("none", A().constant("?")),
    "branch": lambda g, P, A, I: g.V().branch(lambda v: v.label())
    .option("god", A().values("name")).option("any", A().constant(1))
    .option("none", A().constant(0)),
    "project": lambda g, P, A, I: g.V().has_label("god")
    .project("n", "out").by("name").by(A().out().count()),
    "group": lambda g, P, A, I: g.V().group().by(lambda v: v.label())
    .by("name"),
    "group_count_agg": lambda g, P, A, I: g.V().group()
    .by(lambda v: v.label()).by(A().count()),
    "group_count": lambda g, P, A, I: g.V().out().group_count("name"),
    "group_count_by": lambda g, P, A, I: g.V().group_count()
    .by(lambda v: v.label()),
    "group_count_elements": lambda g, P, A, I: g.V().out("brother")
    .group_count(),
    "local": lambda g, P, A, I: g.V().has_label("god")
    .local(A().out_e().limit(1).in_v()).values("name"),
    "store_cap": lambda g, P, A, I: g.V().has_label("god").store("x")
    .out("lives").cap("x"),
    "aggregate_cap": lambda g, P, A, I: g.V().has_label("god")
    .aggregate("x").out("brother").cap("x"),
    "fold_unfold": lambda g, P, A, I: g.V().has_label("god").values("age")
    .fold().unfold(),
    "fold": lambda g, P, A, I: g.V().values("name").fold(),
    "unfold_map": lambda g, P, A, I: g.V().has("name", "saturn")
    .value_map().unfold(),
    "constant": lambda g, P, A, I: g.V().has_label("location")
    .constant("loc"),
    "sum": lambda g, P, A, I: g.V().values("age").sum_(),
    "max": lambda g, P, A, I: g.V().values("age").max_(),
    "min": lambda g, P, A, I: g.V().values("age").min_(),
    "mean": lambda g, P, A, I: g.V().values("age").mean(),
    "empty_sum": lambda g, P, A, I: g.V().has("age", P.gt(10 ** 6))
    .values("age").sum_(),
    "match": lambda g, P, A, I: g.V().match(
        A().as_("a").out("father").as_("b"),
        A().as_("b").out("father").as_("c")).select("a", "c").by("name"),
    "match_join": lambda g, P, A, I: g.V().match(
        A().as_("a").out("brother").as_("b"),
        A().as_("b").out("brother").as_("a")).select("a", "b"),
    "double_underscore": lambda g, P, A, I: g.V().where(
        _dunder(A).out("pet")).values("name"),
    "text_predicate": lambda g, P, A, I: g.V().out_e("lives")
    .has("reason", P.text_contains("loves")).in_v().values("name"),
}


def _dunder(A):
    """The package's ``__`` (TP3's anonymous-traversal namespace)."""
    import sys
    return sys.modules[A.__module__].__


@pytest.fixture(params=["bulk", "no_bulk"])
def bulking(request, monkeypatch):
    if request.param == "no_bulk":
        monkeypatch.setenv("TITAN_TPU_NO_BULK", "1")
    else:
        monkeypatch.delenv("TITAN_TPU_NO_BULK", raising=False)
    return request.param


def run_chain(graphs, chains, name):
    got = {}
    for which, g in graphs.items():
        _, _, P, dsl, _ = PKGS[which]
        t = chains[name](g.traversal(), P, dsl.anon, ids_by_name(g))
        got[which] = [canon(x) for x in t.to_list()]
        g.rollback()
    return got


@pytest.mark.parametrize("name", sorted(GODS))
def test_every_step_on_the_gods_equals_jax(pantheon, bulking, name):
    got = run_chain(pantheon, GODS, name)
    assert got["port"] == got["jax"]
    if name not in ("limit_zero", "empty_sum"):
        assert got["port"], name


def test_sack_with_by_equals_jax(pantheon, bulking):
    got = {}
    for which, g in pantheon.items():
        A = PKGS[which][3].anon
        got[which] = (
            g.traversal().with_sack(1).V().has("name", "hercules")
            .out_e("battled").sack(operator.add).by("time").in_v().sack()
            .to_list(),
            g.traversal().with_sack(lambda: 0.5).V().has_label("god")
            .sack().to_list(),
            g.traversal().with_sack(0).V().has("name", "jupiter")
            .repeat(A().out_e("brother").sack(operator.add).by(
                lambda e: 1).in_v()).times(2).sack().to_list())
        g.rollback()
    assert got["port"] == got["jax"]
    assert got["port"][0] == [2, 3, 13]


#: on the seeded 40-person graph: bulking's effect on path multiplicity
PEOPLE = {
    "k_hop_counts": lambda g, P, A, I: g.V().out().out().out().count(),
    "k_hop_dedup": lambda g, P, A, I: g.V().out("knows").out("likes")
    .dedup().count(),
    "group_count": lambda g, P, A, I: g.V().out().out().group_count("age"),
    "sum_mean": lambda g, P, A, I: g.V().out().out().values("age").mean(),
    "fold_len": lambda g, P, A, I: g.V().out().out().fold().unfold().count(),
    "limit_split": lambda g, P, A, I: g.V().out().out().limit(37).id_(),
    "path_count": lambda g, P, A, I: g.V().out().out().path().count(),
    "repeat_emit_count": lambda g, P, A, I: g.V().has("name", "p0")
    .repeat(A().both()).times(3).emit().count(),
    "indexed_start": lambda g, P, A, I: g.V().has("name", "p3")
    .has("age", P.gte(20)).both().values("name"),
    "order_limit": lambda g, P, A, I: g.V().order().by("age")
    .by("name", desc=True).limit(5).values("name"),
}


@pytest.fixture(scope="module")
def crowd():
    out = {w: people(w) for w in PKGS}
    yield out
    for g in out.values():
        g.close()


@pytest.mark.parametrize("name", sorted(PEOPLE))
def test_bulking_on_and_off_equals_jax(crowd, bulking, name):
    got = run_chain(crowd, PEOPLE, name)
    assert got["port"] == got["jax"]
    assert got["port"]


def test_profile_stages_equal_jax(crowd):
    names = {}
    for which, g in crowd.items():
        P = PKGS[which][2]
        m = g.traversal().V().has("name", "p3").out().out().has(
            "age", P.gt(30)).values("name").profile()
        names[which] = [(s.name, s.count) for s in m.steps]
        assert not m.compiled and m.total_ns > 0
        g.rollback()
    assert names["port"] == names["jax"]
    assert names["port"][0][0] == "V(indexed)"


@pytest.mark.parametrize("misuse", [
    lambda t, A: t.V().by("name"),
    lambda t, A: t.V().option("x", A().out()),
    lambda t, A: t.V().times(2),
    lambda t, A: t.V().match(),
    lambda t, A: t.V().match(A().out()),
    lambda t, A: t.V().match(A().as_("a").out().as_("b"),
                             A().as_("c").out()),
    lambda t, A: t.V().step_that_does_not_exist(),
])
def test_misuse_raises_as_jax(pantheon, misuse):
    errors = {}
    for which, g in pantheon.items():
        A = PKGS[which][3].anon
        with pytest.raises((ValueError, AttributeError)) as e:
            misuse(g.traversal(), A).to_list()
        errors[which] = (type(e.value).__name__,
                         str(e.value).replace("titan_tpu_torch", "titan_tpu"))
        g.rollback()
    assert errors["port"] == errors["jax"]
    with pytest.raises(ValueError, match="anonymous"):
        PDsl.anon().out().to_list()


def test_add_v_and_next_in_an_explicit_transaction(pantheon):
    got = {}
    for which, g in pantheon.items():
        tx = g.new_transaction()
        src = PKGS[which][3].GraphTraversalSource(g, tx=tx)
        v = src.add_v("titan", name="rhea", age=9000).next()
        got[which] = (v.value("name"),
                      src.V().has("name", "rhea").values("age").next(),
                      src.V().has_label("titan").count().next())
        tx.rollback()
        with pytest.raises(StopIteration):
            g.traversal().V().has("name", "rhea").next()
    assert got["port"] == got["jax"] == ("rhea", 9000, 2)


def test_traversal_batch_and_barrier_options_equal_jax():
    """``query.batch`` and ``query.barrier-size`` (the dsl's TRAVERSAL_BATCH
    and BARRIER_SIZE) read as JAX reads them."""
    got = {}
    for which in PKGS:
        pkg, _, P, dsl, example = PKGS[which]
        from torch_twins import open_twin
        g = open_twin(which, config={"storage.backend": "inmemory",
                                     "query.traversal-batch": 3,
                                     "query.barrier-size": 2})
        try:
            example.load(g)
            t = g.traversal().V().out().out().limit(5)
            got[which] = ([canon(x) for x in t.to_list()],
                          t._opt_int("TRAVERSAL_BATCH", -1),
                          t._opt_int("BARRIER_SIZE", -1))
        finally:
            g.close()
    assert got["port"] == got["jax"]
    assert got["port"][1:] == (3, 2)


# -- the TP3 differential run -------------------------------------------------

def build_pair_port(seed: int, n: int = 24, m: int = 60):
    """tests/test_tp3_differential.build_pair on the port's graph: the
    same seeded vertices and edges, and the oracle's dict graph."""
    rng = random.Random(seed)
    g = titan_tpu_torch.open("inmemory")
    tx = g.new_transaction()
    og = {"vertices": {}, "edges": {}, "out": {}, "in": {}}
    vs = []
    for i in range(n):
        label = rng.choice(V_LABELS)
        props = {"name": f"n{i}"}
        if rng.random() < 0.8:
            props["age"] = rng.randint(0, 50)
        vs.append(tx.add_vertex(label, **props))
        og["vertices"][i] = {"label": label, "props": dict(props)}
        og["out"][i] = []
        og["in"][i] = []
    for j in range(m):
        a, b = rng.randrange(n), rng.randrange(n)
        if a == b:
            continue
        label = rng.choice(E_LABELS)
        props = {"eid": f"e{j}"}
        if rng.random() < 0.7:
            props["weight"] = rng.randint(1, 9)
        vs[a].add_edge(label, vs[b], **props)
        og["edges"][f"e{j}"] = {"src": a, "dst": b, "label": label,
                                "props": dict(props)}
        og["out"][a].append(f"e{j}")
        og["in"][b].append(f"e{j}")
    tx.commit()
    idmap = {vs[i].id: ("v", f"n{i}") for i in range(n)}
    return g, og, idmap


_PREDS = {"eq": PP.eq, "neq": PP.neq, "gt": PP.gt, "gte": PP.gte,
          "lt": PP.lt, "lte": PP.lte}


def _to_pred(p):
    if p[0] == "within":
        return PP.within(*p[1])
    if p[0] == "between":
        return PP.between(p[1], p[2])
    return _PREDS[p[0]](p[1])


#: spec step -> the port's dsl call (tests/test_tp3_differential.to_dsl)
_SIMPLE = {"out": "out", "in": "in_", "both": "both", "outE": "out_e",
           "inE": "in_e", "bothE": "both_e"}


def to_port_dsl(t, spec):
    A = PDsl.anon
    for step in spec:
        op = step[0]
        if op == "V":
            t = t.V()
        elif op in _SIMPLE:
            t = getattr(t, _SIMPLE[op])(*step[1])
        elif op in ("outV", "inV", "otherV"):
            t = {"outV": t.out_v, "inV": t.in_v, "otherV": t.other_v}[op]()
        elif op == "has":
            t = t.has(step[1], _to_pred(step[2]))
        elif op == "hasLabel":
            t = t.has_label(*step[1])
        elif op == "values":
            t = t.values(*step[1])
        elif op == "dedup":
            t = t.dedup()
        elif op == "limit":
            t = t.limit(step[1])
        elif op == "order":
            t = t.order(by=step[1], desc=step[2])
        elif op == "as":
            t = t.as_(step[1])
        elif op == "select":
            t = t.select(*step[1])
            if step[2] is not None:
                t = t.by(step[2])
        elif op in ("where", "not"):
            sub = to_port_dsl(A(), step[1])
            t = t.where(sub) if op == "where" else t.not_(sub)
        elif op in ("union", "coalesce"):
            t = getattr(t, op)(*[to_port_dsl(A(), s) for s in step[1]])
        elif op == "repeat":
            t = t.repeat(to_port_dsl(A(), step[1]))
            stop = step[2]
            t = t.times(stop[1]) if stop[0] == "times" \
                else t.until(to_port_dsl(A(), stop[1]))
            if step[3]:
                t = t.emit()
        elif op == "simplePath":
            t = t.simple_path()
        elif op == "path":
            t = t.path()
        elif op in ("count", "mean"):
            t = getattr(t, op)()
        elif op in ("sum", "min", "max"):
            t = getattr(t, op + "_")()
        elif op == "groupCount":
            t = t.group_count(by=step[1])
        else:
            raise ValueError(f"to_port_dsl: unknown step {step!r}")
    return t


def canon_port(x):
    """tests/test_tp3_differential.canon_dsl for the port's elements."""
    kind = type(x).__name__
    if kind == "Vertex":
        return ("v", x.value("name"))
    if kind == "Edge":
        return ("e", x.value("eid"))
    if isinstance(x, dict):
        return tuple(sorted((k if isinstance(k, str) else canon_port(k),
                             canon_port(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(canon_port(i) for i in x)
    if isinstance(x, float):
        return round(x, 9)
    return x


@pytest.mark.parametrize("gseed", [1, 2])
def test_random_traversals_match_the_tp3_oracle(gseed):
    g, og, idmap = build_pair_port(gseed)
    try:
        rng = random.Random(1000 * gseed)
        failures = []
        for q in range(60):
            spec, mode = gen_spec(rng)
            raw = to_port_dsl(g.traversal(), spec).to_list()
            if mode == "groupcount" and raw and isinstance(raw[0], dict):
                raw = [{idmap.get(k, k): v for k, v in raw[0].items()}]
            mine = [canon_port(x) for x in raw]
            want = [canon_oracle(og, x)
                    for x in tp3_oracle.evaluate(og, spec)]
            if mode == "list":
                ok = mine == want
            else:
                ok = sorted(map(repr, mine)) == sorted(map(repr, want)) or (
                    mode == "groupcount" and len(mine) == len(want) == 1
                    and sorted(map(repr, mine[0]))
                    == sorted(map(repr, want[0])))
            if not ok:
                failures.append((q, spec, mine[:8], want[:8]))
        assert not failures, (
            f"{len(failures)} mismatching traversals; first: "
            f"{failures[0]}")
    finally:
        g.close()
