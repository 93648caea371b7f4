"""Remote index provider: an index node over HTTP + the client adapter.

The networked index tier (reference: titan-es ElasticSearchIndex.java — an
external index SERVICE reached over the network implementing the
IndexProvider SPI; titan-solr plays the same role). An ``IndexServer``
hosts any local provider (the FTS5 engine for persistence, the in-memory
one for tests); ``RemoteIndexProvider`` — configured as
``index.<name>.backend=remote-index`` with hostname/port — forwards the
SPI over JSON. Values ride the framework's self-describing attribute
serializer (base64) so Geoshape/datetime/etc. round-trip; predicate trees
are reconstructed server-side from (op, value) pairs.
"""

from __future__ import annotations

import base64
from typing import Optional

from titan_tpu_torch.codec.attributes import Serializer
from titan_tpu_torch.errors import PermanentBackendError
from titan_tpu_torch.utils.httpnode import JsonNode, json_call, run_node_cli
from titan_tpu_torch.indexing.provider import (And, FieldCondition,
                                               IndexFeatures, IndexMutation,
                                               IndexProvider, IndexQuery,
                                               KeyInformation, Not, Or,
                                               RawQuery)
from titan_tpu_torch.query.predicates import P

_SER = Serializer()


def _v(x) -> str:
    return base64.b64encode(_SER.value_bytes(x)).decode()


def _uv(s: str):
    return _SER.value_from_bytes(base64.b64decode(s))


_MULTI_OPS = {"between", "inside", "within", "without"}


def _p_to_wire(p: P) -> dict:
    # multi-valued predicates carry tuples/sets, which the attribute
    # serializer doesn't encode — ship their elements individually
    if p.op in _MULTI_OPS:
        return {"op": p.op, "vs": [_v(x) for x in p.value]}
    return {"op": p.op, "value": _v(p.value)}


_P_FACTORIES = {
    "eq": P.eq, "neq": P.neq, "lt": P.lt, "lte": P.lte, "gt": P.gt,
    "gte": P.gte,
    "between": lambda v: P.between(*v), "inside": lambda v: P.inside(*v),
    "within": lambda v: P.within(*v), "without": lambda v: P.without(*v),
    "textContains": P.text_contains, "textPrefix": P.text_prefix,
    "textRegex": P.text_regex, "stringPrefix": P.string_prefix,
    "stringRegex": P.string_regex, "geoWithin": P.geo_within,
    "geoIntersect": P.geo_intersect, "geoDisjoint": P.geo_disjoint,
    "geoContains": P.geo_contains,
}


def _p_from_wire(d: dict) -> P:
    try:
        factory = _P_FACTORIES[d["op"]]
    except KeyError:
        raise PermanentBackendError(f"unknown predicate op {d['op']!r}")
    if "vs" in d:
        # every multi-op factory takes the value sequence as ONE argument
        # (the lambdas in _P_FACTORIES unpack as needed)
        return factory([_uv(x) for x in d["vs"]])
    return factory(_uv(d["value"]))


def _cond_to_wire(c) -> dict:
    if isinstance(c, FieldCondition):
        return {"t": "f", "field": c.field, "p": _p_to_wire(c.predicate)}
    if isinstance(c, And):
        return {"t": "and", "c": [_cond_to_wire(x) for x in c.children]}
    if isinstance(c, Or):
        return {"t": "or", "c": [_cond_to_wire(x) for x in c.children]}
    if isinstance(c, Not):
        return {"t": "not", "c": _cond_to_wire(c.child)}
    raise PermanentBackendError(f"unserializable condition {type(c).__name__}")


def _cond_from_wire(d: dict):
    t = d["t"]
    if t == "f":
        return FieldCondition(d["field"], _p_from_wire(d["p"]))
    if t == "and":
        return And(tuple(_cond_from_wire(x) for x in d["c"]))
    if t == "or":
        return Or(tuple(_cond_from_wire(x) for x in d["c"]))
    if t == "not":
        return Not(_cond_from_wire(d["c"]))
    raise PermanentBackendError(f"unknown condition tag {t!r}")


class IndexServer(JsonNode):
    """Hosts a local IndexProvider as an index node (the dtype in
    register() travels by NAME through the schema dtype registry, so
    Geoshape/datetime keys keep their real type server-side)."""

    def __init__(self, provider: IndexProvider, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__(self._dispatch, host, port, name="index-node")
        self.provider = provider

    def _dispatch(self, path: str, req: dict):
        from titan_tpu_torch.core.schema import _DTYPES
        p = self.provider
        if path == "/register":
            try:
                dtype = _DTYPES[req["dtype"]]
            except KeyError:
                raise PermanentBackendError(
                    f"unknown dtype name {req['dtype']!r}")
            from titan_tpu_torch.core.defs import Cardinality
            info = KeyInformation(
                dtype, Cardinality(req.get("cardinality", "single")),
                parameters=tuple(req["parameters"]))
            p.register(req["store"], req["key"], info)
            return {"ok": True}
        if path == "/mutate":
            muts = {}
            for store, per_doc in req["mutations"].items():
                m = muts.setdefault(store, {})
                for docid, d in per_doc.items():
                    m[docid] = IndexMutation(
                        {k: _uv(v) for k, v in d["add"].items()},
                        set(d["del"]), d["deleted"])
            p.mutate(muts)
            return {"ok": True}
        if path == "/query":
            q = IndexQuery(
                _cond_from_wire(req["condition"]),
                orders=tuple((f, o) for f, o in req["orders"]),
                limit=req.get("limit"))
            return {"ids": p.query(req["store"], q)}
        if path == "/raw":
            hits = p.raw_query(req["store"],
                               RawQuery(req["query"],
                                        limit=req.get("limit"),
                                        offset=req.get("offset", 0)))
            return {"hits": [[d, s] for d, s in hits]}
        if path == "/admin":
            op = req["op"]
            if op == "features":
                f = p.features
                return {"supports_text": f.supports_text,
                        "supports_geo": f.supports_geo,
                        "supports_numeric_range": f.supports_numeric_range,
                        "supports_order": f.supports_order,
                        "supports_raw_query": f.supports_raw_query}
            if op == "drop_store":
                p.drop_store(req["store"])
            elif op == "clear":
                p.clear_storage()
            elif op == "flush":
                flush = getattr(p, "flush", None)
                if flush:
                    flush()
            else:
                raise PermanentBackendError(f"unknown admin op {op!r}")
            return {"ok": True}
        raise PermanentBackendError(f"unknown endpoint {path!r}")


class RemoteIndexProvider(IndexProvider):
    """Client side of the index node (titan-es role)."""

    def __init__(self, name: str = "search", directory=None,
                 hostname: str = "127.0.0.1", port: int = 8284,
                 timeout: float = 30.0):
        self.name = name
        self._url = f"http://{hostname}:{port}"
        self._timeout = timeout
        # mirror the NODE's capabilities (it may host any provider)
        f = self._call("/admin", {"op": "features"})
        self._features = IndexFeatures(
            supports_text=f["supports_text"],
            supports_geo=f["supports_geo"],
            supports_numeric_range=f["supports_numeric_range"],
            supports_order=f["supports_order"],
            supports_raw_query=f["supports_raw_query"])

    def _call(self, path: str, payload: dict) -> dict:
        return json_call(self._url, path, payload, timeout=self._timeout)

    @property
    def features(self) -> IndexFeatures:
        return self._features

    def register(self, store: str, key: str, info: KeyInformation) -> None:
        from titan_tpu_torch.core.schema import _DTYPE_NAMES
        self._call("/register", {
            "store": store, "key": key,
            # by NAME via the dtype registry — a "sample value" degrades
            # Geoshape/datetime keys to str on the node
            "dtype": _DTYPE_NAMES.get(info.dtype, "str"),
            "cardinality": info.cardinality.value,
            "parameters": list(info.parameters)})

    def mutate(self, mutations) -> None:
        wire = {}
        for store, per_doc in mutations.items():
            m = wire.setdefault(store, {})
            for docid, mut in per_doc.items():
                m[docid] = {"add": {k: _v(v)
                                    for k, v in mut.additions.items()},
                            "del": sorted(mut.deletions),
                            "deleted": mut.deleted}
        self._call("/mutate", {"mutations": wire})

    def query(self, store: str, query: IndexQuery) -> list:
        res = self._call("/query", {
            "store": store, "condition": _cond_to_wire(query.condition),
            "orders": [list(o) for o in query.orders],
            "limit": query.limit})
        return res["ids"]

    def raw_query(self, store: str, query: RawQuery) -> list:
        res = self._call("/raw", {"store": store, "query": query.query,
                                  "limit": query.limit,
                                  "offset": query.offset})
        return [(d, float(s)) for d, s in res["hits"]]

    def drop_store(self, store: str) -> None:
        self._call("/admin", {"op": "drop_store", "store": store})

    def clear_storage(self) -> None:
        self._call("/admin", {"op": "clear"})

    def flush(self) -> None:
        self._call("/admin", {"op": "flush"})

    def close(self) -> None:
        pass


def main(argv: Optional[list] = None) -> None:
    """``python -m titan_tpu_torch.indexing.remote <data-dir> [port] [host]`` —
    run an index node (FTS5-backed, binds 0.0.0.0 by default) mounted with
    ``index.<name>.backend=remote-index``."""
    def make(directory, host, port):
        from titan_tpu_torch.indexing.ftsindex import FTSIndex
        return IndexServer(FTSIndex("node", directory), host=host,
                           port=port or 8284)
    run_node_cli(argv, "usage: python -m titan_tpu_torch.indexing.remote "
                       "<data-dir> [port] [host]", make)


if __name__ == "__main__":
    main()
