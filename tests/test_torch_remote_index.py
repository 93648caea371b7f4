"""The port's index providers against the JAX package's: the SPI suite of
``tests/test_ftsindex.py`` over ``MemoryIndex``, ``FTSIndex`` (in memory
and on disk) and a ``RemoteIndexProvider`` before an ``IndexServer``, the
wire suite of ``tests/test_remote_index.py`` with the client of either
package before the node of either package, a graph over
``remote-index``, and the loader that refuses an index directory written
by the JAX package. Hits exact, in the order the providers give them."""

import importlib
import io
import pickle

import pytest

from torch_twins import open_twin

ROOT = {"jax": "titan_tpu", "port": "titan_tpu_torch"}
BOTH = ("jax", "port")
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port"),
         ("jax", "jax")]


def mod(which: str, name: str):
    return importlib.import_module(f"{ROOT[which]}.{name}")


class Provider:
    """A provider of one package (``kind``: mem, fts, fts-disk, or
    remote: a MemoryIndex behind an IndexServer of ``node`` package)."""

    def __init__(self, which, kind, tmp_path, node=None):
        self.which = which
        self.server = None
        self.pr = mod(which, "indexing.provider")
        if kind == "mem":
            self.p = mod(which, "indexing.memindex").MemoryIndex("t")
        elif kind == "fts":
            self.p = mod(which, "indexing.ftsindex").FTSIndex("t")
        elif kind == "fts-disk":
            self.p = mod(which, "indexing.ftsindex").FTSIndex(
                "t", str(tmp_path / which / "idx"))
        else:
            node = node or which
            self.server = mod(node, "indexing.remote").IndexServer(
                mod(node, "indexing.memindex").MemoryIndex("node")).start()
            self.p = mod(which, "indexing.remote").RemoteIndexProvider(
                "t", hostname="127.0.0.1", port=self.server.port)

    @property
    def P(self):
        return mod(self.which, "query.predicates").P

    def q(self, cond, **kw):
        return self.pr.IndexQuery(cond, **kw)

    def f(self, field, pred):
        return self.pr.FieldCondition(field, pred)

    def fill(self):
        KI = self.pr.KeyInformation
        self.p.register("s", "title", KI(str))
        self.p.register("s", "sku", KI(str, parameters=("STRING",)))
        self.p.register("s", "price", KI(float))
        for docid, title, sku, price in (
                ("d1", "red fish blue fish", "A-1", 3.5),
                ("d2", "one fish two fish", "A-2", 9.0),
                ("d3", "green eggs and ham", "B-1", 5.0)):
            tx = self.p.begin_transaction()
            tx.add("s", docid, "title", title)
            tx.add("s", docid, "sku", sku)
            tx.add("s", docid, "price", price)
            tx.commit()

    def close(self):
        self.p.close()
        if self.server is not None:
            self.server.stop()


def spi_suite(pv: Provider) -> list:
    """Every call of the SPI suite; returns what each answered."""
    P, f, q, p = pv.P, pv.f, pv.q, pv.p
    RawQuery = pv.pr.RawQuery
    pv.fill()
    out = [p.query("s", q(f("title", P.text_contains("fish")))),
           p.query("s", q(f("title", P.text_contains("blue fish")))),
           p.query("s", q(pv.pr.And((f("title", P.text_contains("fish")),
                                     f("price", P.gt(4.0)))))),
           p.query("s", q(f("sku", P.eq("B-1")))),
           p.query("s", q(f("price", P.gt(0.0)), orders=(("price", "desc"),),
                          limit=2)),
           p.query("s", q(f("price", P.between(3.0, 5.0)))),
           p.query("s", q(f("price", P.within(9.0, 11.0)))),
           p.query("s", q(pv.pr.Or((f("sku", P.eq("A-1")),
                                    f("sku", P.eq("B-1")))))),
           p.query("s", q(pv.pr.Not(f("title", P.text_contains("fish"))))),
           sorted(d for d, _ in p.raw_query("s", RawQuery("title:fish"))),
           p.raw_query("s", RawQuery("fish eggs")),
           len(p.raw_query("s", RawQuery("title:fish", limit=1))),
           [(p.features.supports_text, p.features.supports_geo,
             p.features.supports_raw_query)]]
    tx = p.begin_transaction()
    tx.delete("s", "d1", "title")
    tx.commit()
    out.append(p.query("s", q(f("title", P.text_contains("fish")))))
    tx = p.begin_transaction()
    tx.delete_document("s", "d2")
    tx.commit()
    out.append(p.query("s", q(f("title", P.text_contains("fish")))))
    out.append(p.query("s", q(f("price", P.lt(6.0)))))
    p.drop_store("s")
    out.append(p.query("s", q(f("price", P.gt(0.0)))))
    return out


@pytest.mark.parametrize("kind", ["mem", "fts", "fts-disk", "remote"])
def test_the_provider_spi_equals_jax(kind, tmp_path):
    got = {}
    for which in BOTH:
        pv = Provider(which, kind, tmp_path)
        try:
            got[which] = spi_suite(pv)
        finally:
            pv.close()
    assert got["port"] == got["jax"]
    assert got["port"][:5] == [["d1", "d2"], ["d1"], ["d2"], ["d3"],
                               ["d2", "d3"]]
    assert got["port"][-4:] == [["d2"], [], ["d1", "d3"], []]


@pytest.mark.parametrize("client,node", PAIRS)
def test_the_wire_in_every_pairing(client, node, tmp_path):
    """A client of one package before the node of the other: the SPI suite
    answers as it does within one package, geo and multi-valued
    predicates included."""
    pv = Provider(client, "remote", tmp_path, node=node)
    try:
        got = spi_suite(pv)
        Geo = mod(client, "core.attribute").Geoshape
        pv.p.register("g", "spot", pv.pr.KeyInformation(Geo))
        tx = pv.p.begin_transaction()
        tx.add("g", "d1", "spot", Geo.point(10.0, 10.0))
        tx.add("g", "d2", "spot", Geo.point(40.0, -74.0))
        tx.commit()
        geo = pv.p.query("g", pv.q(pv.f("spot", pv.P.geo_within(
            Geo.circle(10.0, 10.0, 50.0)))))
    finally:
        pv.close()
    ref = Provider("port", "mem", tmp_path)
    try:
        assert got == spi_suite(ref)
    finally:
        ref.close()
    assert geo == ["d1"]


def test_an_fts_backed_node(tmp_path):
    got = {}
    for which in BOTH:
        server = mod(which, "indexing.remote").IndexServer(
            mod(which, "indexing.ftsindex").FTSIndex(
                "node", str(tmp_path / which))).start()
        try:
            pv = Provider(which, "mem", tmp_path)
            pv.p = mod(which, "indexing.remote").RemoteIndexProvider(
                "t", hostname="127.0.0.1", port=server.port)
            pv.fill()
            got[which] = pv.p.raw_query("s", pv.pr.RawQuery("fish"))
            pv.p.flush()
        finally:
            server.stop()
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 2 and all(s > 0 for _, s in got["port"])


def test_fts_persistence_across_reopen(tmp_path):
    got = {}
    for which in BOTH:
        pv = Provider(which, "fts-disk", tmp_path)
        pv.fill()
        pv.close()
        FTS = mod(which, "indexing.ftsindex").FTSIndex
        p2 = FTS("t", str(tmp_path / which / "idx"))
        try:
            pv.p = p2
            got[which] = (
                p2.query("s", pv.q(pv.f("title",
                                        pv.P.text_contains("fish")))),
                p2.query("s", pv.q(pv.f("sku", pv.P.eq("A-2")))),
                p2.raw_query("s", pv.pr.RawQuery("eggs")))
        finally:
            p2.close()
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (["d1", "d2"], ["d2"])
    assert got["port"][2][0][0] == "d3"


@pytest.mark.parametrize("node", BOTH)
def test_a_graph_with_a_remote_mixed_index(node):
    """``index.search.backend: remote-index`` before a node of either
    package: the port graph's covered query and ``index_query`` equal the
    JAX graph's before the same kind of node."""
    got = {}
    for which in BOTH:
        server = mod(node, "indexing.remote").IndexServer(
            mod(node, "indexing.memindex").MemoryIndex("node")).start()
        g = open_twin(which, config={
            "storage.backend": "inmemory",
            "index.search.backend": "remote-index",
            "index.search.hostname": ["127.0.0.1"],
            "index.search.port": server.port})
        try:
            P = mod(which, "query.predicates").P
            mgmt = g.management()
            mgmt.build_index("bios", "vertex").add_key(
                mgmt.make_property_key("bio", str), "TEXT") \
                .build_mixed_index("search")
            mgmt.commit()
            tx = g.new_transaction()
            v = tx.add_vertex("person", bio="graphs on tensor processors")
            tx.add_vertex("person", bio="tables on spinning disks")
            tx.commit()
            tx2 = g.new_transaction()
            hits = [x.id for x in tx2.query().has(
                "bio", P.text_contains("tensor")).vertices()]
            tx2.rollback()
            raw = [(el.id, s) for el, s in g.index_query("bios",
                                                          "bio:graphs")]
            assert hits == [v.id] and [i for i, _ in raw] == [v.id]
            got[which] = (hits, raw,
                          type(g.index_provider("search")).__name__)
        finally:
            g.close()
            server.stop()
    assert got["port"] == got["jax"]


def test_the_index_node_cli_needs_a_directory(capsys):
    with pytest.raises(SystemExit) as exc:
        mod("port", "indexing.remote").main([])
    assert exc.value.code == 2
    assert "titan_tpu_torch.indexing.remote" in capsys.readouterr().err


# -- the loader: each package reads only its own index directories ------------

def _write_memindex(which, d):
    pr = mod(which, "indexing.provider")
    p = mod(which, "indexing.memindex").MemoryIndex("search", str(d))
    p.register("s", "code", pr.KeyInformation(str, parameters=("STRING",)))
    tx = p.begin_transaction()
    tx.add("s", "d1", "code", "alpha")
    tx.commit()
    p.close()


def test_a_jax_written_memindex_directory_fails_loudly(tmp_path):
    _write_memindex("jax", tmp_path / "jax")
    with pytest.raises(pickle.UnpicklingError, match="titan_tpu"):
        mod("port", "indexing.memindex").MemoryIndex(
            "search", str(tmp_path / "jax"))
    _write_memindex("port", tmp_path / "port")
    p = mod("port", "indexing.memindex").MemoryIndex(
        "search", str(tmp_path / "port"))
    pr = mod("port", "indexing.provider")
    assert p.query("s", pr.IndexQuery(pr.FieldCondition(
        "code", mod("port", "query.predicates").P.eq("alpha")))) == ["d1"]
    assert p._stores["s"].keyinfo["code"].parameters == ("STRING",)


def test_a_jax_written_fts_directory_fails_loudly(tmp_path):
    for which in BOTH:
        pr = mod(which, "indexing.provider")
        p = mod(which, "indexing.ftsindex").FTSIndex(
            "search", str(tmp_path / which))
        p.register("s", "title", pr.KeyInformation(str))
        p.close()
    with pytest.raises(pickle.UnpicklingError, match="titan_tpu"):
        mod("port", "indexing.ftsindex").FTSIndex("search",
                                                  str(tmp_path / "jax"))
    p = mod("port", "indexing.ftsindex").FTSIndex("search",
                                                  str(tmp_path / "port"))
    try:
        assert p._keyinfo[("s", "title")].dtype is str
    finally:
        p.close()


def test_the_loader_admits_the_schema_datatypes_and_refuses_the_rest():
    """Documents, key registrations and snapshots hold the schema's
    datatypes in builtin containers; any other global is refused."""
    import datetime
    import decimal
    import uuid
    from titan_tpu_torch.core.attribute import Geoshape
    from titan_tpu_torch.indexing.provider import KeyInformation, load_pickle
    doc = {"when": datetime.datetime(2020, 1, 2, 3, 4, 5),
           "id": uuid.UUID(int=7), "price": decimal.Decimal("1.25"),
           "spot": Geoshape.point(1.0, 2.0), "tags": {"a", "b"},
           "n": (1, 2.5, b"x", None, True), "info": KeyInformation(
               Geoshape, parameters=("STRING",))}
    assert load_pickle(pickle.dumps(doc)) == doc
    assert load_pickle(io.BytesIO(pickle.dumps(doc))) == doc
    for bad in (pickle.dumps(pickle.Pickler), b"cos\nsystem\n(S'true'\ntR.",
                b"cbuiltins\neval\n(S'1'\ntR."):
        with pytest.raises(pickle.UnpicklingError):
            load_pickle(bad)


def test_a_memindex_directory_keeps_only_the_last_writer_s_snapshot(
        tmp_path):
    """ROADMAP queue 3, item 14, in both packages: two ``MemoryIndex``
    instances over one directory (two graphs, as concurrent scan splits
    open them) each snapshot their whole store on flush, so the later
    flush drops the earlier one's documents. ``lucene`` and an
    ``IndexServer`` keep both."""
    got = {}
    for which in BOTH:
        pr = mod(which, "indexing.provider")
        Mem = mod(which, "indexing.memindex").MemoryIndex
        FTS = mod(which, "indexing.ftsindex").FTSIndex
        out = []
        for make in (lambda: Mem("search", str(tmp_path / which / "m")),
                     lambda: FTS("search", str(tmp_path / which / "f"))):
            a, b = make(), make()
            for p, docid in ((a, "d1"), (b, "d2")):
                p.register("s", "code", pr.KeyInformation(
                    str, parameters=("STRING",)))
                tx = p.begin_transaction()
                tx.add("s", docid, "code", docid)
                tx.commit()
            a.close()
            b.close()
            c = make()
            out.append(c.query("s", pr.IndexQuery(pr.FieldCondition(
                "code", mod(which, "query.predicates").P.within(
                    "d1", "d2")))))
            c.close()
        got[which] = out
    assert got["port"] == got["jax"] == [["d2"], ["d1", "d2"]]
