"""Graph file IO: GraphSON-style JSON lines and a compact binary snapshot
(the port's copy of ``titan_tpu/io.py``: the same markers, format version
and bytes, so either package reads the other's files).

(reference: titan-core graphdb/tinkerpop/TitanIoRegistry.java — Titan
registers Geoshape/RelationIdentifier serializers with TinkerPop's
GraphSON and Gryo writers, and the TP3 surface is
``graph.io(IoCore.graphson()).writeGraph(file)``. Here both formats are
native: the JSON format mirrors GraphSON 3's star-vertex adjacency-list
shape; the binary format plays Gryo's role using the framework's own
self-describing attribute serializer, codec/attributes.py.)

Both formats carry the schema (property keys with dtype/cardinality, edge
labels with multiplicity/sort keys, vertex labels, graph indexes) ahead of
the data, so importing into an empty graph reproduces schema first and
index population happens naturally as vertices commit.

Vertex ids are NOT preserved on import (the target graph allocates its
own); edges are resolved through an id remap table. Multi-cardinality
properties appear once per value; vertex-property meta-properties and edge
properties round-trip.
"""

from __future__ import annotations

import base64
import datetime as _dt
import decimal as _decimal
import json
import uuid as _uuid
from typing import Any, BinaryIO, Iterator, Optional, TextIO

from titan_tpu_torch.core.attribute import Geoshape
from titan_tpu_torch.core.defs import Cardinality, Multiplicity
from titan_tpu_torch.errors import TitanError
from titan_tpu_torch.utils import varint

_GRAPHSON_MARKER = "titan-tpu-graphson"
_BIN_MAGIC = b"TITANTPUBIN1\n"
_FORMAT_VERSION = 1

# ---------------------------------------------------------------------------
# value <-> JSON encoding (GraphSON-style typed values)
# ---------------------------------------------------------------------------


def _enc(v: Any) -> Any:
    """JSON-safe encoding; non-native types become {"@type", "@value"}."""
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            return {"@type": "float", "@value": repr(v)}
        return v
    if isinstance(v, bytes):
        return {"@type": "bytes",
                "@value": base64.b64encode(v).decode("ascii")}
    if isinstance(v, _uuid.UUID):
        return {"@type": "uuid", "@value": str(v)}
    if isinstance(v, _dt.datetime):
        return {"@type": "datetime", "@value": v.isoformat()}
    if isinstance(v, _dt.date):
        return {"@type": "date", "@value": v.isoformat()}
    if isinstance(v, _dt.time):
        return {"@type": "time", "@value": v.isoformat()}
    if isinstance(v, _dt.timedelta):
        return {"@type": "timedelta", "@value": v.total_seconds()}
    if isinstance(v, _decimal.Decimal):
        return {"@type": "decimal", "@value": str(v)}
    if isinstance(v, Geoshape):
        return {"@type": "geoshape", "@value": v.to_floats()}
    import numpy as np
    if isinstance(v, np.ndarray):
        return {"@type": "ndarray",
                "@value": [str(v.dtype), list(v.shape),
                           base64.b64encode(
                               np.ascontiguousarray(v).tobytes())
                           .decode("ascii")]}
    if isinstance(v, list):
        return [_enc(x) for x in v]
    if isinstance(v, tuple):
        return {"@type": "tuple", "@value": [_enc(x) for x in v]}
    if isinstance(v, frozenset):
        return {"@type": "frozenset", "@value": [_enc(x) for x in v]}
    if isinstance(v, set):
        return {"@type": "set", "@value": [_enc(x) for x in v]}
    if isinstance(v, dict):
        if all(isinstance(k, str) for k in v) and "@type" not in v:
            return {k: _enc(x) for k, x in v.items()}
        return {"@type": "dict",
                "@value": [[_enc(k), _enc(x)] for k, x in v.items()]}
    raise TitanError(f"cannot JSON-encode value of type {type(v).__name__}")


def _dec(v: Any) -> Any:
    if isinstance(v, list):
        return [_dec(x) for x in v]
    if not isinstance(v, dict):
        return v
    t = v.get("@type")
    if t is None:
        return {k: _dec(x) for k, x in v.items()}
    val = v["@value"]
    if t == "float":
        return float(val)
    if t == "bytes":
        return base64.b64decode(val)
    if t == "uuid":
        return _uuid.UUID(val)
    if t == "datetime":
        return _dt.datetime.fromisoformat(val)
    if t == "date":
        return _dt.date.fromisoformat(val)
    if t == "time":
        return _dt.time.fromisoformat(val)
    if t == "timedelta":
        return _dt.timedelta(seconds=val)
    if t == "decimal":
        return _decimal.Decimal(val)
    if t == "geoshape":
        return Geoshape.from_floats(val)
    if t == "ndarray":
        import numpy as np
        dtype, shape, b64 = val
        return np.frombuffer(base64.b64decode(b64),
                             dtype=np.dtype(dtype)).reshape(shape).copy()
    if t == "tuple":
        return tuple(_dec(x) for x in val)
    if t == "set":
        return set(_dec(x) for x in val)
    if t == "frozenset":
        return frozenset(_dec(x) for x in val)
    if t == "dict":
        return {_dec(k): _dec(x) for k, x in val}
    raise TitanError(f"unknown @type {t!r} in graph file")


# ---------------------------------------------------------------------------
# schema section
# ---------------------------------------------------------------------------


def _schema_dict(graph) -> dict:
    """Schema as name-keyed JSON (sort-key / index-key ids -> names)."""
    schema = graph.schema
    keys, labels, vlabels, indexes = [], [], [], []
    for st in schema.all_types():
        d = st.definition()
        d["name"] = st.name
        if d["kind"] == "key":
            keys.append(d)
        elif d["kind"] == "label":
            d["sort_key"] = [schema.get_type(kid).name
                             for kid in d["sort_key"]]
            labels.append(d)
        elif d["kind"] == "vertexlabel":
            vlabels.append(d)
    for idx in schema.indexes():
        d = idx.definition()
        d["name"] = idx.name
        d["key_ids"] = [schema.get_type(kid).name for kid in d["key_ids"]]
        if d["index_only"]:
            d["index_only"] = schema.get_type(d["index_only"]).name
        indexes.append(d)
    return {"keys": keys, "labels": labels, "vertex_labels": vlabels,
            "indexes": indexes}


def _restore_schema(graph, sd: dict) -> None:
    """Recreate exported schema in the target graph (idempotent: existing
    names are left as-is, matching the reference's read-side leniency)."""
    from titan_tpu_torch.core.schema import _DTYPES
    schema = graph.schema
    mgmt = graph.management()
    try:
        for d in sd.get("keys", ()):
            if schema.get_by_name(d["name"]) is None:
                k = mgmt.make_property_key(
                    d["name"], _DTYPES[d["dtype"]],
                    Cardinality(d["cardinality"]))
                if d.get("ttl"):
                    mgmt.set_ttl(k, d["ttl"])
                if d.get("consistency", "none") != "none":
                    mgmt.set_consistency(k, d["consistency"])
        for d in sd.get("labels", ()):
            if schema.get_by_name(d["name"]) is None:
                sort_ids = tuple(schema.get_by_name(n).id
                                 for n in d.get("sort_key", ()))
                lb = mgmt.make_edge_label(
                    d["name"], Multiplicity(d["multiplicity"]),
                    d.get("unidirected", False), sort_ids)
                if d.get("ttl"):
                    mgmt.set_ttl(lb, d["ttl"])
                if d.get("consistency", "none") != "none":
                    mgmt.set_consistency(lb, d["consistency"])
        for d in sd.get("vertex_labels", ()):
            if schema.get_by_name(d["name"]) is None:
                vl = mgmt.make_vertex_label(d["name"],
                                            d.get("partitioned", False),
                                            d.get("static", False))
                if d.get("ttl"):
                    mgmt.set_ttl(vl, d["ttl"])
        for d in sd.get("indexes", ()):
            if schema.get_by_name(d["name"]) is not None:
                continue
            b = mgmt.build_index(d["name"], d["element"])
            for kname, param in zip(d["key_ids"], d["key_params"]):
                key = mgmt.get_property_key(kname)
                if param and param != "DEFAULT":
                    b.add_key(key, param)
                else:
                    b.add_key(key)
            if d.get("unique"):
                b.unique()
            if d.get("index_only"):
                b.index_only(schema.get_by_name(d["index_only"]))
            if d.get("composite", True):
                b.build_composite_index()
            else:
                b.build_mixed_index(d.get("backing", ""))
        mgmt.commit()
    except BaseException:
        mgmt.rollback()
        raise


# ---------------------------------------------------------------------------
# star-vertex record extraction / insertion (shared by both formats)
# ---------------------------------------------------------------------------


def _vertex_records(graph, tx=None) -> Iterator[tuple]:
    """Yield (vid, label, props, out_edges) star records from ``tx`` (or a
    fresh read-only tx). props: [(key, value, {metakey: metaval})];
    out_edges: [(label, in_vid, {key: value})]."""
    own_tx = tx is None
    if own_tx:
        tx = graph.new_transaction(read_only=True)
    try:
        for v in tx.vertices():
            vid = v.id
            label = v.label()
            if label == "vertex" and not _is_declared_vlabel(graph, label):
                label = None   # the implicit default, not a declared label
            props = []
            for p in tx.vertex_properties(vid):
                meta = {tx.schema_name(kid): mv
                        for kid, mv in p.rel.properties.items()}
                props.append((p.key(), p.value, meta))
            edges = []
            for e in v.out_edges():
                edges.append((e.label(), e.in_vertex().id,
                              e.property_map()))
            yield vid, label, props, edges
    finally:
        if own_tx:
            tx.rollback()


def _is_declared_vlabel(graph, name: str) -> bool:
    st = graph.schema.get_by_name(name)
    return st is not None and st.is_vertex_label


class _Loader:
    """Two-phase import: vertices (with id remap), then edges, with
    batched commits (reference: the batch-loading guidance around
    storage.batch-loading)."""

    def __init__(self, graph, batch_size: int = 10_000):
        self.graph = graph
        self.batch = batch_size
        self.remap: dict[int, int] = {}
        self.vertices = 0
        self.edges = 0
        self._tx = None
        self._pending = 0

    def _ensure_tx(self):
        if self._tx is None:
            self._tx = self.graph.new_transaction()
        return self._tx

    def _tick(self):
        self._pending += 1
        if self._pending >= self.batch:
            self.flush()

    def flush(self):
        if self._tx is not None:
            self._tx.commit()
            self._tx = None
        self._pending = 0

    def add_vertex(self, old_vid: int, label: Optional[str], props) -> None:
        tx = self._ensure_tx()
        v = tx.add_vertex(label) if label else tx.add_vertex()
        self.remap[old_vid] = v.id
        for key, value, meta in props:
            p = tx.add_property(v, key, value)
            for mk, mv in (meta or {}).items():
                tx.add_meta_property(p, mk, mv)
        self.vertices += 1
        self._tick()

    def add_edge(self, out_old: int, label: str, in_old: int, props) -> None:
        tx = self._ensure_tx()
        try:
            out_v = tx.vertex_handle(self.remap[out_old])
            in_v = tx.vertex_handle(self.remap[in_old])
        except KeyError as e:
            raise TitanError(
                f"corrupt graph file: edge references unknown vertex "
                f"{e}") from e
        tx.add_edge(out_v, label, in_v, props or {})
        self.edges += 1
        self._tick()


# ---------------------------------------------------------------------------
# GraphSON-style JSON lines
# ---------------------------------------------------------------------------


def write_graphson(graph, path: str) -> dict:
    """Export the whole graph as JSON lines: a header line with format
    marker + schema, then one star-vertex line per vertex."""
    counts = {"vertices": 0, "edges": 0}
    with open(path, "w", encoding="utf-8") as f:
        _write_graphson_stream(graph, f, counts)
    return counts


def _write_graphson_stream(graph, f: TextIO, counts: dict) -> None:
    header = {_GRAPHSON_MARKER: _FORMAT_VERSION,
              "schema": _schema_dict(graph)}
    f.write(json.dumps(header, separators=(",", ":")) + "\n")
    for vid, label, props, edges in _vertex_records(graph):
        rec = {"id": vid, "label": label,
               "props": [[k, _enc(v), {mk: _enc(mv)
                                       for mk, mv in meta.items()}]
                         for k, v, meta in props],
               "outE": [[lb, ivid, {k: _enc(v) for k, v in ep.items()}]
                        for lb, ivid, ep in edges]}
        f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        counts["vertices"] += 1
        counts["edges"] += len(edges)


def read_graphson(graph, path: str, batch_size: int = 10_000) -> dict:
    """Import a write_graphson file. Two passes over the file: vertices
    (building the id remap), then edges. Returns counts."""
    with open(path, "r", encoding="utf-8") as f:
        first = f.readline()
    if looks_like_tp3_graphson(first):
        # a TinkerPop 3.0.2 adjacency-GraphSON file (the reference's
        # data/*.json format) — accept it transparently
        return read_graphson_tp3(graph, path, batch_size)
    loader = _Loader(graph, batch_size)
    with open(path, "r", encoding="utf-8") as f:
        header = json.loads(f.readline())
        if header.get(_GRAPHSON_MARKER) != _FORMAT_VERSION:
            raise TitanError(f"{path}: not a {_GRAPHSON_MARKER} v"
                             f"{_FORMAT_VERSION} file")
        _restore_schema(graph, header.get("schema", {}))
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            loader.add_vertex(
                rec["id"], rec.get("label"),
                [(k, _dec(v), {mk: _dec(mv) for mk, mv in meta.items()})
                 for k, v, meta in rec.get("props", ())])
        loader.flush()
    with open(path, "r", encoding="utf-8") as f:
        f.readline()
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            for lb, ivid, ep in rec.get("outE", ()):
                loader.add_edge(rec["id"], lb, ivid,
                                {k: _dec(v) for k, v in ep.items()})
        loader.flush()
    return {"vertices": loader.vertices, "edges": loader.edges}


# ---------------------------------------------------------------------------
# TinkerPop 3.0.2 adjacency GraphSON (true wire compatibility)
# ---------------------------------------------------------------------------
# The reference embeds TinkerPop 3.0.2 (reference: pom.xml:62) whose
# ``graph.io(IoCore.graphson()).writeGraph`` emits ONE untyped JSON object
# per vertex in adjacency form — the exact shape of the files the
# reference ships in titan-dist/src/assembly/static/data/
# (tinkerpop-modern.json etc.):
#
#   {"id":1,"label":"person",
#    "outE":{"knows":[{"id":7,"inV":2,"properties":{"weight":0.5}}]},
#    "inE":{"created":[{"id":9,"outV":4,"properties":{...}}]},
#    "properties":{"name":[{"id":0,"value":"marko"}]}}
#
# write_graphson_tp3/read_graphson_tp3 speak that format verbatim so
# files interoperate with the TP3 ecosystem the reference lives in
# (reference: graphdb/tinkerpop/TitanIoRegistry.java registers Titan's
# serializers with TinkerPop's writers). Values that have no native JSON
# representation (Geoshape, bytes, UUID, datetimes...) use the typed
# {"@type","@value"} escape — the analog of the reference needing
# TitanGraphSONModule for the same types. TP GraphSON carries NO schema:
# import relies on the automatic schema maker, exactly like the
# reference loading these files into a fresh graph.


def write_graphson_tp3(graph, path: str) -> dict:
    """Export in TinkerPop 3.0.2 adjacency GraphSON (see block comment).
    Every edge appears twice (out-vertex's outE and in-vertex's inE),
    matching TinkerPop's writer; empty sections are omitted."""
    counts = {"vertices": 0, "edges": 0}
    tx = graph.new_transaction(read_only=True)
    try:
        with open(path, "w", encoding="utf-8") as f:
            for v in tx.vertices():
                rec: dict = {"id": v.id, "label": v.label()}
                out_e: dict = {}
                for e in v.out_edges():
                    out_e.setdefault(e.label(), []).append(
                        {"id": e.rel.relation_id, "inV": e.in_vertex().id,
                         **({"properties":
                             {k: _enc(val) for k, val
                              in e.property_map().items()}}
                            if e.property_map() else {})})
                in_e: dict = {}
                for e in v.in_edges():
                    in_e.setdefault(e.label(), []).append(
                        {"id": e.rel.relation_id,
                         "outV": e.out_vertex().id,
                         **({"properties":
                             {k: _enc(val) for k, val
                              in e.property_map().items()}}
                            if e.property_map() else {})})
                props: dict = {}
                for p in tx.vertex_properties(v.id):
                    props.setdefault(p.key(), []).append(
                        {"id": p.rel.relation_id, "value": _enc(p.value)})
                if out_e:
                    rec["outE"] = out_e
                if in_e:
                    rec["inE"] = in_e
                if props:
                    rec["properties"] = props
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
                counts["vertices"] += 1
                counts["edges"] += sum(len(x) for x in out_e.values())
    finally:
        tx.rollback()
    return counts


def looks_like_tp3_graphson(first_line: str) -> bool:
    try:
        rec = json.loads(first_line)
    except (ValueError, TypeError):
        return False
    return (isinstance(rec, dict) and "id" in rec
            and _GRAPHSON_MARKER not in rec
            and ("outE" in rec or "inE" in rec or "properties" in rec
                 or "label" in rec))


def read_graphson_tp3(graph, path: str, batch_size: int = 10_000) -> dict:
    """Import a TinkerPop 3.0.2 adjacency-GraphSON file (the reference's
    data/*.json format). Edges are taken from ``outE`` only (each edge's
    canonical appearance); ``inE`` entries are the mirrored copies and
    are ignored. Vertex ids are remapped (as all importers here do)."""
    loader = _Loader(graph, batch_size)
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            props = []
            for key, plist in (rec.get("properties") or {}).items():
                if isinstance(plist, list):
                    for p in plist:
                        props.append((key, _dec(p.get("value")), {}))
                else:          # tolerate scalar shorthand
                    props.append((key, _dec(plist), {}))
            label = rec.get("label")
            if label == "vertex":
                label = None
            loader.add_vertex(rec["id"], label, props)
        loader.flush()
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            for lb, elist in (rec.get("outE") or {}).items():
                for e in elist:
                    loader.add_edge(
                        rec["id"], lb, e["inV"],
                        {k: _dec(v) for k, v
                         in (e.get("properties") or {}).items()})
        loader.flush()
    return {"vertices": loader.vertices, "edges": loader.edges}


# ---------------------------------------------------------------------------
# binary snapshot (Gryo role)
# ---------------------------------------------------------------------------

_TAG_VERTEX = 1
_TAG_EDGE = 2
_TAG_END = 0


def _w_varint(f: BinaryIO, v: int) -> None:
    out = bytearray()
    varint.write_positive(out, v)
    f.write(out)


def _w_value(f: BinaryIO, serializer, v: Any) -> None:
    b = serializer.value_bytes(v)
    _w_varint(f, len(b))
    f.write(b)


def _w_str(f: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    _w_varint(f, len(b))
    f.write(b)


class _BinReader:
    def __init__(self, f: BinaryIO, serializer):
        self.data = f.read()
        self.pos = 0
        self.ser = serializer

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise TitanError(
                "corrupt graph file: truncated (wanted %d bytes at offset "
                "%d of %d)" % (n, self.pos, len(self.data)))
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(b)

    def byte(self) -> int:
        return self._take(1)[0]

    def varint(self) -> int:
        try:
            v, self.pos = varint.read_positive(self.data, self.pos)
        except (IndexError, ValueError) as e:
            raise TitanError(f"corrupt graph file: bad varint at offset "
                             f"{self.pos}: {e}") from e
        return v

    def value(self) -> Any:
        b = self._take(self.varint())
        try:
            return self.ser.value_from_bytes(b)
        except Exception as e:
            raise TitanError(
                f"corrupt graph file: undecodable value: {e}") from e

    def str_(self) -> str:
        b = self._take(self.varint())
        try:
            return b.decode("utf-8")
        except UnicodeDecodeError as e:
            raise TitanError(
                f"corrupt graph file: undecodable string: {e}") from e


def write_graphbin(graph, path: str) -> dict:
    """Export the whole graph in the compact binary snapshot format
    (schema JSON blob, then tagged vertex/edge records; values use the
    framework's self-describing attribute serializer)."""
    ser = graph.serializer
    counts = {"vertices": 0, "edges": 0}
    with open(path, "wb") as f:
        f.write(_BIN_MAGIC)
        blob = json.dumps(_schema_dict(graph),
                          separators=(",", ":")).encode("utf-8")
        _w_varint(f, len(blob))
        f.write(blob)
        # two passes over the graph so edges stream instead of spooling
        # in memory (vertex records must all precede edge records — the
        # loader's remap table needs every vertex before the first edge).
        # BOTH passes run inside ONE read-only tx: with two separate txs a
        # concurrent writer between the passes could add edges referencing
        # vertices absent from the vertex section, making the snapshot
        # unimportable.
        tx = graph.new_transaction(read_only=True)
        try:
            for vid, label, props, _edges in _vertex_records(graph, tx):
                f.write(bytes([_TAG_VERTEX]))
                _w_varint(f, vid)
                _w_str(f, label or "")
                _w_varint(f, len(props))
                for k, v, meta in props:
                    _w_str(f, k)
                    _w_value(f, ser, v)
                    _w_varint(f, len(meta))
                    for mk, mv in meta.items():
                        _w_str(f, mk)
                        _w_value(f, ser, mv)
                counts["vertices"] += 1
            for vid, _label, _props, edges in _vertex_records(graph, tx):
                for lb, ivid, ep in edges:
                    f.write(bytes([_TAG_EDGE]))
                    _w_varint(f, vid)
                    _w_varint(f, ivid)
                    _w_str(f, lb)
                    _w_varint(f, len(ep))
                    for k, v in ep.items():
                        _w_str(f, k)
                        _w_value(f, ser, v)
                    counts["edges"] += 1
        finally:
            tx.rollback()
        f.write(bytes([_TAG_END]))
    return counts


def read_graphbin(graph, path: str, batch_size: int = 10_000) -> dict:
    loader = _Loader(graph, batch_size)
    with open(path, "rb") as f:
        magic = f.read(len(_BIN_MAGIC))
        if magic != _BIN_MAGIC:
            raise TitanError(f"{path}: not a titan-tpu binary graph file")
        r = _BinReader(f, graph.serializer)
    try:
        sd = json.loads(r._take(r.varint()).decode("utf-8"))
    except ValueError as e:
        raise TitanError(f"corrupt graph file: bad schema blob: {e}") from e
    _restore_schema(graph, sd)
    while True:
        tag = r.byte()
        if tag == _TAG_END:
            break
        if tag == _TAG_VERTEX:
            vid = r.varint()
            label = r.str_() or None
            props = []
            for _ in range(r.varint()):
                k = r.str_()
                v = r.value()
                meta = {}
                for _ in range(r.varint()):
                    mk = r.str_()
                    meta[mk] = r.value()
                props.append((k, v, meta))
            loader.add_vertex(vid, label, props)
        elif tag == _TAG_EDGE:
            out_old = r.varint()
            in_old = r.varint()
            lb = r.str_()
            ep = {}
            for _ in range(r.varint()):
                k = r.str_()
                ep[k] = r.value()
            loader.add_edge(out_old, lb, in_old, ep)
        else:
            raise TitanError(f"corrupt graph file: unknown record tag {tag}")
    loader.flush()
    return {"vertices": loader.vertices, "edges": loader.edges}
