"""Twin graphs for the port's query and traversal tests: the same seeded
operations on ``titan_tpu.open`` and ``titan_tpu_torch.open`` with
``SimpleBulkPlacement`` seeded in both, so element ids agree, and a
canonical form for what the two packages' traversals return (their
``Vertex``/``Edge`` handles are different classes)."""

import random

import titan_tpu
import titan_tpu_torch
from titan_tpu import example as jax_example
from titan_tpu.ids.placement import SimpleBulkPlacement as JPlace
from titan_tpu.query.predicates import P as JP
from titan_tpu.traversal import dsl as jax_dsl
from titan_tpu_torch import example as port_example
from titan_tpu_torch.ids.placement import SimpleBulkPlacement as PPlace
from titan_tpu_torch.query.predicates import P as PP
from titan_tpu_torch.traversal import dsl as port_dsl

#: per package: (module, placement, P, dsl, example)
PKGS = {"jax": (titan_tpu, JPlace, JP, jax_dsl, jax_example),
        "port": (titan_tpu_torch, PPlace, PP, port_dsl, port_example)}


def open_twin(which: str, seed: int = 11, config=None):
    """A graph whose partition placement is seeded, so both packages give
    the same ids for the same operations."""
    pkg, place = PKGS[which][:2]
    g = pkg.open(config or "inmemory")
    g.id_assigner.placement = place(g.idm.num_partitions, batch_size=5,
                                    seed=seed)
    return g


def gods(which: str):
    """The graph of the gods (``example.load``) on a twin graph."""
    g = open_twin(which)
    PKGS[which][4].load(g)
    return g


def people(which: str, seed: int = 11, n: int = 40, m: int = 200,
           config=None):
    """tests/test_olap_compile.py's ``gp`` shape on a twin graph: n
    persons named p<i> with ages 20-69, m random knows/likes edges (no
    self loops), one commit."""
    g = open_twin(which, config=config)
    rng = random.Random(seed)
    tx = g.new_transaction()
    vs = [tx.add_vertex("person", name=f"p{i}", age=20 + (i * 7) % 50)
          for i in range(n)]
    for _ in range(m):
        a, b = rng.sample(range(n), 2)
        tx.add_edge(vs[a], rng.choice(["knows", "likes"]), vs[b])
    tx.commit()
    return g


def complete(which: str, n: int = 50):
    """K_n: every ordered pair of distinct vertices an edge."""
    g = open_twin(which)
    tx = g.new_transaction()
    vs = [tx.add_vertex("node") for _ in range(n)]
    for a in vs:
        for b in vs:
            if a is not b:
                a.add_edge("link", b)
    tx.commit()
    return g


def canon(x):
    """A traversal output in a form both packages share: elements by
    kind and id, property handles by id, key and value, geoshapes by
    their fields, lists element-wise, dicts as sorted pairs."""
    kind = type(x).__name__
    if kind == "Vertex":
        return ("v", x.id)
    if kind == "Edge":
        return ("e", x.id)
    if kind == "VertexProperty":
        return ("p", x.id, x.key(), canon(x.value))
    if kind == "Geoshape":
        return ("geo", x.kind, x.coords, x.radius)
    if isinstance(x, dict):
        return ("dict", tuple(sorted(((canon(k), canon(v))
                                      for k, v in x.items()), key=repr)))
    if isinstance(x, (list, tuple)):
        return tuple(canon(i) for i in x)
    return x
