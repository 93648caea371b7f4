"""GraphOfTheGods: the canonical demo dataset.

(reference: titan-core titan/example/GraphOfTheGodsFactory.java:26,52 — same
schema and data: 12 vertices (titan/god/demigod/human/monster/location),
17 edges (father/mother/brother/battled/lives/pet) with battled sort-keyed
by time and carrying a Geoshape battle place, lives carrying a reason, a
composite (optionally unique) name index, and optional mixed indexes on
vertex age and edge reason+place.)

The port's copy of ``titan_tpu/example.py``.
"""

from __future__ import annotations

from titan_tpu_torch.core.attribute import Geoshape
from titan_tpu_torch.core.defs import Multiplicity


def load(graph, batch: bool = False, mixed_index_name=None,
         unique_name_index: bool = False):
    schema = graph.schema
    mgmt = graph.management()
    name = schema.get_by_name("name") or mgmt.make_property_key("name", str)
    age = schema.get_by_name("age") or mgmt.make_property_key("age", int)
    time = schema.get_by_name("time") or mgmt.make_property_key("time", int)
    reason = schema.get_by_name("reason") or mgmt.make_property_key(
        "reason", str)
    place = schema.get_by_name("place") or mgmt.make_property_key(
        "place", Geoshape)

    def activate(idx_name):
        # indexes over PRE-EXISTING keys start INSTALLED; walk them through
        # REGISTER -> REINDEX (which enables) so they actually serve queries
        # and enforce uniqueness (reference: SchemaAction lifecycle)
        idx = mgmt.get_graph_index(idx_name)
        if idx is not None and not idx.queryable:
            mgmt.update_index(idx_name, "register")
            mgmt.update_index(idx_name, "reindex")

    if schema.get_by_name("name_idx") is None:
        b = mgmt.build_index("name_idx", "vertex").add_key(name)
        if unique_name_index:
            b.unique()
        b.build_composite_index()
        activate("name_idx")
    if mixed_index_name and schema.get_by_name("vertices") is None:
        mgmt.build_index("vertices", "vertex").add_key(age) \
            .build_mixed_index(mixed_index_name)
        activate("vertices")
    if mixed_index_name and schema.get_by_name("edges") is None:
        mgmt.build_index("edges", "edge").add_key(reason).add_key(place) \
            .build_mixed_index(mixed_index_name)
        activate("edges")
    mgmt.commit()

    schema.get_by_name("father") or schema.make_edge_label(
        "father", Multiplicity.MANY2ONE)
    schema.get_by_name("mother") or schema.make_edge_label(
        "mother", Multiplicity.MANY2ONE)
    schema.get_by_name("battled") or schema.make_edge_label(
        "battled", Multiplicity.MULTI, sort_key=(time.id,))
    schema.get_by_name("lives") or schema.make_edge_label(
        "lives", Multiplicity.MULTI)
    schema.get_by_name("pet") or schema.make_edge_label("pet", Multiplicity.MULTI)
    schema.get_by_name("brother") or schema.make_edge_label(
        "brother", Multiplicity.MULTI)

    for label in ["titan", "location", "god", "demigod", "human", "monster"]:
        schema.get_by_name(label) or schema.make_vertex_label(label)

    tx = graph.new_transaction()
    saturn = tx.add_vertex("titan", name="saturn", age=10000)
    sky = tx.add_vertex("location", name="sky")
    sea = tx.add_vertex("location", name="sea")
    jupiter = tx.add_vertex("god", name="jupiter", age=5000)
    neptune = tx.add_vertex("god", name="neptune", age=4500)
    hercules = tx.add_vertex("demigod", name="hercules", age=30)
    alcmene = tx.add_vertex("human", name="alcmene", age=45)
    pluto = tx.add_vertex("god", name="pluto", age=4000)
    nemean = tx.add_vertex("monster", name="nemean")
    hydra = tx.add_vertex("monster", name="hydra")
    cerberus = tx.add_vertex("monster", name="cerberus")
    tartarus = tx.add_vertex("location", name="tartarus")

    jupiter.add_edge("father", saturn)
    jupiter.add_edge("lives", sky, reason="loves fresh breezes")
    jupiter.add_edge("brother", neptune)
    jupiter.add_edge("brother", pluto)
    neptune.add_edge("lives", sea, reason="loves waves")
    neptune.add_edge("brother", jupiter)
    neptune.add_edge("brother", pluto)
    hercules.add_edge("father", jupiter)
    hercules.add_edge("mother", alcmene)
    hercules.add_edge("battled", nemean, time=1,
                      place=Geoshape.point(38.1, 23.7))
    hercules.add_edge("battled", hydra, time=2,
                      place=Geoshape.point(37.7, 23.9))
    hercules.add_edge("battled", cerberus, time=12,
                      place=Geoshape.point(39.0, 22.0))
    pluto.add_edge("brother", jupiter)
    pluto.add_edge("brother", neptune)
    pluto.add_edge("lives", tartarus, reason="no fear of death")
    pluto.add_edge("pet", cerberus)
    cerberus.add_edge("lives", tartarus)
    tx.commit()
    return graph
