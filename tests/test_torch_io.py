"""The port's graph file IO (titan_tpu_torch.io) against the JAX package's
titan_tpu.io on twin graphs (tests/torch_twins.open_twin: the same seeded
operations give the same ids): GraphSON, TP3 GraphSON and graphbin files
written by either package are byte-equal to the other's, each package
reads the other's file into an equal graph, and the round trips of
tests/test_io.py hold on the port."""

import datetime
import decimal
import json
import uuid
from datetime import timezone as _tz

import numpy as np
import pytest

import titan_tpu
import titan_tpu_torch
from titan_tpu import io as jio
from titan_tpu.core.attribute import Geoshape as JGeo
from titan_tpu.core.defs import Cardinality as JCard, Multiplicity as JMult
from titan_tpu_torch import io as pio
from titan_tpu_torch.core.attribute import Geoshape as PGeo
from titan_tpu_torch.core.defs import (Cardinality as PCard,
                                       Multiplicity as PMult)
from titan_tpu_torch.errors import TitanError
from titan_tpu import example as jex
from titan_tpu_torch import example as pex
from torch_twins import open_twin

PKGS = {"jax": (jio, JGeo, JCard, JMult, titan_tpu),
        "port": (pio, PGeo, PCard, PMult, titan_tpu_torch)}
WRITERS = {"graphson": ("write_graphson", "read_graphson"),
           "tp3": ("write_graphson_tp3", "read_graphson_tp3"),
           "graphbin": ("write_graphbin", "read_graphbin")}
_TP3_FIXTURE = __file__.rsplit("/", 1)[0] + "/data/tp3_adjacency_sample.json"
#: an in-memory graph whose commits do not sleep out the claim waits
FAST = {"storage.backend": "inmemory", "storage.lock.wait-time": 5,
        "ids.authority.wait-time": 5}


def twin(which: str, seed: int = 11):
    return open_twin(which, seed=seed, config=dict(FAST))


def fresh():
    return titan_tpu_torch.open(dict(FAST))


def rich(which: str):
    """tests/test_io.py's rich graph (every special value type, a LIST
    key with a meta-property, a sort key, an index) on a twin graph."""
    _, geo, card, mult, _ = PKGS[which]
    g = twin(which)
    mgmt = g.management()
    name = mgmt.make_property_key("name", str)
    mgmt.make_property_key("nick", str, card.LIST)
    when = mgmt.make_property_key("when", datetime.datetime)
    mgmt.make_property_key("price", decimal.Decimal)
    mgmt.make_edge_label("knows", mult.MULTI, sort_key=(when.id,))
    mgmt.make_vertex_label("person")
    mgmt.make_vertex_label("hub", partitioned=False, static=False)
    mgmt.build_index("byName", "vertex").add_key(name) \
        .build_composite_index()
    mgmt.commit()
    tx = g.new_transaction()
    a = tx.add_vertex("person", name="alice")
    p = tx.add_property(a, "nick", "ally")
    tx.add_meta_property(p, "since", 2020)
    tx.add_property(a, "nick", "al")
    tx.add_property(a, "when",
                    datetime.datetime(2021, 3, 4, 5, 6, 7, tzinfo=_tz.utc))
    tx.add_property(a, "price", decimal.Decimal("12.50"))
    tx.add_property(a, "uid", uuid.UUID(int=7))
    tx.add_property(a, "blob", b"\x00\x01\xff")
    tx.add_property(a, "spot", geo.point(37.1, -122.3))
    tx.add_property(a, "tags", ("x", "y"))
    tx.add_property(a, "score", float("nan"))
    tx.add_property(a, "emb", np.arange(6, dtype=np.float32).reshape(2, 3))
    b = tx.add_vertex("person", name="bob")
    c = tx.add_vertex(name="carol")
    tx.add_edge(a, "knows", b,
                {"when": datetime.datetime(2022, 1, 1, tzinfo=_tz.utc),
                 "weight": 0.5})
    tx.add_edge(b, "knows", c,
                {"when": datetime.datetime(2023, 1, 1, tzinfo=_tz.utc)})
    tx.commit()
    return g


def gods(which: str):
    g = twin(which)
    (jex if which == "jax" else pex).load(g)
    return g


def chain(which: str, n: int = 50):
    g = twin(which)
    tx = g.new_transaction()
    vs = [tx.add_vertex(n=i) for i in range(n)]
    for i in range(n - 1):
        tx.add_edge(vs[i], "next", vs[i + 1])
    tx.commit()
    return g


MAKERS = {"rich": rich, "gods": gods, "chain": chain}


@pytest.fixture(params=sorted(MAKERS))
def twins(request):
    gs = {w: MAKERS[request.param](w) for w in PKGS}
    yield gs
    for g in gs.values():
        g.close()


def _write(which, fmt, g, path):
    return getattr(PKGS[which][0], WRITERS[fmt][0])(g, str(path))


def _read(which, fmt, g, path, **kw):
    return getattr(PKGS[which][0], WRITERS[fmt][1])(g, str(path), **kw)


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_files_are_byte_equal_across_packages(twins, fmt, tmp_path):
    pj, pp = tmp_path / "jax", tmp_path / "port"
    cj = _write("jax", fmt, twins["jax"], pj)
    cp = _write("port", fmt, twins["port"], pp)
    assert cj == cp and cp["vertices"] > 0
    assert pp.read_bytes() == pj.read_bytes()


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_each_package_reads_the_other_s_file(twins, fmt, tmp_path):
    """The port reads a JAX-written file and JAX a port-written one into
    fresh twin graphs; both graphs write out byte-equal again (so their
    schema, elements, values and ids are equal)."""
    src = tmp_path / "src"
    want = _write("jax", fmt, twins["jax"], src)
    targets = {w: twin(w, seed=5) for w in PKGS}
    try:
        for w, g in targets.items():
            assert _read(w, fmt, g, src) == want
        again = {}
        for w, g in targets.items():
            again[w] = tmp_path / f"again_{w}"
            _write(w, fmt, g, again[w])
        assert again["port"].read_bytes() == again["jax"].read_bytes()
    finally:
        for g in targets.values():
            g.close()
    port_src = tmp_path / "port_src"
    _write("port", fmt, twins["port"], port_src)
    g = twin("jax", seed=5)
    try:
        assert _read("jax", fmt, g, port_src) == want
    finally:
        g.close()


def _check_rich(g):
    """tests/test_io.py's _check_graph on the port's graph."""
    schema = g.schema
    assert schema.get_by_name("nick").cardinality is PCard.LIST
    assert schema.get_by_name("when").dtype is datetime.datetime
    knows = schema.get_by_name("knows")
    assert knows.multiplicity is PMult.MULTI
    assert [schema.get_type(k).name for k in knows.sort_key] == ["when"]
    idx = schema.get_by_name("byName")
    assert idx.composite and \
        [schema.get_type(k).name for k in idx.key_ids] == ["name"]
    tx = g.new_transaction()
    alice = next(v for v in tx.vertices() if v.value("name") == "alice")
    assert alice.label() == "person"
    assert sorted(alice.values("nick")) == ["al", "ally"]
    assert alice.value("when") == datetime.datetime(2021, 3, 4, 5, 6, 7,
                                                    tzinfo=_tz.utc)
    assert alice.value("price") == decimal.Decimal("12.50")
    assert alice.value("uid") == uuid.UUID(int=7)
    assert alice.value("blob") == b"\x00\x01\xff"
    assert alice.value("spot") == PGeo.point(37.1, -122.3)
    assert alice.value("tags") == ("x", "y")
    assert np.isnan(alice.value("score"))
    assert np.array_equal(alice.value("emb"),
                          np.arange(6, dtype=np.float32).reshape(2, 3))
    ally = next(p for p in alice.properties("nick") if p.value == "ally")
    assert ally.meta("since") == 2020
    e = next(iter(alice.out_edges("knows")))
    assert e.in_vertex().value("name") == "bob"
    assert e.value("weight") == 0.5
    carol = next(v for v in tx.vertices() if v.value("name") == "carol")
    assert carol.label() == "vertex"
    assert len(g.traversal().V().has("name", "bob").to_list()) == 1
    tx.rollback()


@pytest.mark.parametrize("fmt", ["graphson", "graphbin"])
def test_rich_round_trip_on_the_port(fmt, tmp_path):
    g = rich("port")
    g2 = fresh()
    try:
        path = tmp_path / "g"
        assert _write("port", fmt, g, path) == {"vertices": 3, "edges": 2}
        assert _read("port", fmt, g2, path) == {"vertices": 3, "edges": 2}
        _check_rich(g2)
    finally:
        g.close()
        g2.close()


def test_gods_and_batched_import_on_the_port(tmp_path):
    g, g2 = gods("port"), fresh()
    try:
        path = str(tmp_path / "gods.json")
        out = pio.write_graphson(g, path)
        assert pio.read_graphson(g2, path, batch_size=3) == out
        assert out["vertices"] == 12
        q = (lambda x: sorted(x.traversal().V().has("name", "hercules")
                              .out("father").out("lives").values("name")
                              .to_list()))
        assert q(g) == q(g2) == ["sky"]
    finally:
        g.close()
        g2.close()
    g, g2 = chain("port"), fresh()
    try:
        pio.write_graphson(g, str(tmp_path / "c.json"))
        assert pio.read_graphson(g2, str(tmp_path / "c.json"),
                                 batch_size=7) == {"vertices": 50,
                                                   "edges": 49}
        assert g2.traversal().V().has("n", 0).out("next").out("next") \
            .values("n").to_list() == [2]
    finally:
        g.close()
        g2.close()


def test_tp3_fixture_imports_alike(tmp_path):
    gs = {w: twin(w) for w in PKGS}
    try:
        for w in PKGS:
            assert _read(w, "tp3", gs[w], _TP3_FIXTURE) == \
                {"vertices": 4, "edges": 3}
            assert PKGS[w][0].read_graphson(twin(w), _TP3_FIXTURE) \
                == {"vertices": 4, "edges": 3}
        for w in PKGS:
            _write(w, "tp3", gs[w], tmp_path / w)
        assert (tmp_path / "port").read_bytes() == \
            (tmp_path / "jax").read_bytes()
        recs = [json.loads(x) for x in open(tmp_path / "port") if x.strip()]
        by_name = {r["properties"]["name"][0]["value"]: r for r in recs}
        assert by_name["ada"]["label"] == "engineer"
        assert "outE" not in by_name["loner"]
        assert pio.looks_like_tp3_graphson(
            open(tmp_path / "port").readline())
    finally:
        for g in gs.values():
            g.close()


def test_bad_truncated_and_dangling_files_raise_titan_error(tmp_path):
    g = fresh()
    src = rich("port")
    try:
        p = tmp_path / "x.json"
        p.write_text('{"something": 1}\n')
        with pytest.raises(TitanError):
            pio.read_graphson(g, str(p))
        pb = tmp_path / "x.bin"
        pb.write_bytes(b"NOTBIN")
        with pytest.raises(TitanError):
            pio.read_graphbin(g, str(pb))
        full = tmp_path / "full.bin"
        pio.write_graphbin(src, str(full))
        data = full.read_bytes()
        assert data.startswith(b"TITANTPUBIN1\n")
        for cut in (len(data) // 3, len(data) // 2, len(data) - 1):
            frag = tmp_path / f"cut{cut}.bin"
            frag.write_bytes(data[:cut])
            gx = fresh()
            try:
                with pytest.raises(TitanError):
                    pio.read_graphbin(gx, str(frag))
            finally:
                gx.close()
        pj = tmp_path / "g.json"
        pio.write_graphson(src, str(pj))
        lines = pj.read_text().splitlines()
        assert json.loads(lines[0]).get("titan-tpu-graphson") == 1
        rec = json.loads(lines[1])
        rec["outE"] = [["knows", 99999999, {}]]
        pj.write_text("\n".join([lines[0], json.dumps(rec)]) + "\n")
        gy = fresh()
        try:
            with pytest.raises(TitanError):
                pio.read_graphson(gy, str(pj))
        finally:
            gy.close()
    finally:
        g.close()
        src.close()


@pytest.mark.parametrize("v", [
    None, True, 7, -(1 << 62), 1.5, float("inf"), "s", b"\x00\xff",
    uuid.UUID(int=99), decimal.Decimal("-0.001"),
    datetime.datetime(2020, 2, 29, 1, 2, 3, 456789, tzinfo=_tz.utc),
    datetime.date(1999, 12, 31), ("a", 1), [1, [2, "b"]], {"k": [1, 2]}],
    ids=repr)
def test_value_encodings_equal_jax(v):
    enc = pio._enc(v)
    assert json.dumps(enc) == json.dumps(jio._enc(v))
    assert pio._dec(json.loads(json.dumps(enc))) == \
        jio._dec(json.loads(json.dumps(enc)))


def test_geoshape_encodes_like_jax():
    for jg, pg in ((JGeo.point(1.5, -2.0), PGeo.point(1.5, -2.0)),
                   (JGeo.circle(10, 20, 5), PGeo.circle(10, 20, 5)),
                   (JGeo.box(0, 0, 1, 1), PGeo.box(0, 0, 1, 1))):
        assert json.dumps(pio._enc(pg)) == json.dumps(jio._enc(jg))
        assert pio._dec(pio._enc(pg)) == pg
