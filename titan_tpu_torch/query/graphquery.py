"""Graph-centric queries: ``g.query().has(...)`` with index selection.

(reference: titan-core graphdb/query/graph/GraphCentricQueryBuilder.java:426
— pick the best composite index (all keys matched by equality), fall back to
mixed indexes whose provider supports the predicates, intersect multiple
retrievals (QueryUtil.processIntersectingRetrievals), and finally full-scan
with a warning (StandardTitanTx.java:1260-1282). Results always re-filter
against the full condition set and merge the transaction's own deltas.)

The port's copy of ``titan_tpu/query/graphquery.py``: the composite cover
goes through ``indexing/serializer.query_composite``, the mixed cover
through the graph's ``index_provider`` (``indexing/``).
"""

from __future__ import annotations

import logging
from typing import Any, Iterator, Optional

from titan_tpu_torch.core.defs import Direction, RelationCategory
from titan_tpu_torch.core.schema import IndexDefinition, PropertyKey
from titan_tpu_torch.errors import TitanError
from titan_tpu_torch.query.predicates import P

log = logging.getLogger(__name__)

_EXISTS = object()


class GraphQuery:
    """Builder for graph-centric element retrieval."""

    def __init__(self, tx):
        self.tx = tx
        self.schema = tx.schema
        self._conditions: list[tuple[str, P]] = []
        self._label: Optional[str] = None
        self._orders: list[tuple[str, str]] = []
        self._limit: Optional[int] = None
        from titan_tpu_torch.query.profile import NO_OP
        self._profiler = NO_OP

    # -- builder -------------------------------------------------------------

    def has(self, key: str, value: Any = _EXISTS) -> "GraphQuery":
        if value is _EXISTS:
            self._conditions.append((key, P("exists", None,
                                            lambda c: c is not None)))
        elif isinstance(value, P):
            self._conditions.append((key, value))
        else:
            self._conditions.append((key, P.eq(value)))
        return self

    def has_not(self, key: str) -> "GraphQuery":
        self._conditions.append((key, P("absent", None, lambda c: c is None)))
        return self

    def has_label(self, label: str) -> "GraphQuery":
        self._label = label
        return self

    def interval(self, key: str, lo, hi) -> "GraphQuery":
        return self.has(key, P.between(lo, hi))

    def order_by(self, key: str, order: str = "asc") -> "GraphQuery":
        self._orders.append((key, order))
        return self

    def limit(self, n: int) -> "GraphQuery":
        self._limit = n
        return self

    def with_profiler(self, profiler) -> "GraphQuery":
        """Thread a QueryProfiler through execution (reference: profiler
        threading at StandardTitanTx.java:1030,1116,1247)."""
        self._profiler = profiler
        return self

    # -- execution -----------------------------------------------------------

    def vertices(self) -> list:
        return self._execute("vertex")

    def edges(self) -> list:
        return self._execute("edge")

    def count(self) -> int:
        return len(self.vertices())

    def _execute(self, element: str) -> list:
        from titan_tpu_torch.query import profile as prof
        tx = self.tx
        with self._profiler.group(prof.OPTIMIZATION) as p:
            p.annotate("conditions", len(self._conditions))
            ids = self._index_retrieval(element)
            p.annotate("indexed", ids is not None)
        if ids is None:
            with self._profiler.group(prof.FULL_SCAN) as p:
                out = list(self._full_scan(element))
                p.annotate("results", len(out))
        else:
            with self._profiler.group(prof.BACKEND_QUERY) as p:
                p.annotate("hits", len(ids))
                out = []
                seen = set()
                # mixed-edge hits carry only a relation id; resolve them all
                # in ONE edge-store pass instead of one scan per hit
                rel_ids = {h[1] for h in ids
                           if isinstance(h, tuple) and len(h) == 2
                           and h[0] == "rel"}
                rel_map = self._edges_by_rel_ids(rel_ids) if rel_ids else {}
                for eid in ids:
                    if element == "vertex":
                        el = tx.vertex(eid)
                    elif isinstance(eid, tuple) and len(eid) == 2 \
                            and eid[0] == "rel":
                        el = rel_map.get(eid[1])
                    else:
                        el = self._edge_from_hit(eid)
                    if el is None or el.id in seen:
                        continue
                    seen.add(el.id)
                    if self._matches(el):
                        out.append(el)
                # the index can't see this tx's uncommitted elements — merge
                # the tx delta the way edgeProcessor merges adjacency deltas
                out.extend(el for el in self._tx_delta(element)
                           if el.id not in seen and self._matches(el))
                p.annotate("results", len(out))
        for key, direction in reversed(self._orders):
            out.sort(key=lambda el: ((v := el.value(key)) is None, v),
                     reverse=(direction == "desc"))
        if self._limit is not None:
            out = out[:self._limit]
        return out

    # -- matching ------------------------------------------------------------

    def _matches(self, el) -> bool:
        if self._label is not None and el.label() != self._label:
            return False
        for key, pred in self._conditions:
            values = el.values(key) if hasattr(el, "values") else []
            # Edge.values yields None placeholders for absent keys (Vertex
            # yields nothing) — absent is absent for predicate purposes
            values = [v for v in values if v is not None]
            if pred.op == "absent":
                if values:
                    return False
                continue
            if not values:
                return False
            if not any(pred(v) for v in values):
                return False
        return True

    # -- index selection (the GraphCentricQueryBuilder core) -----------------

    def _index_retrieval(self, element: str) -> Optional[list]:
        """Element-id stream from the best index cover, or None when no
        index applies (→ full scan)."""
        eq_keys = {}
        for key, pred in self._conditions:
            if pred.op == "eq":
                eq_keys.setdefault(key, pred.value)
        label_id = 0
        if self._label is not None:
            st = self.schema.get_by_name(self._label)
            if st is not None:
                label_id = st.id

        candidates = [ix for ix in self.schema.indexes(element)
                      if ix.queryable and
                      (not ix.index_only or ix.index_only == label_id)]

        # composite cover: every index key has an equality condition;
        # greedy largest-first, intersecting multiple retrievals
        retrievals = []
        covered: set[str] = set()
        composites = sorted(
            (ix for ix in candidates if ix.composite),
            key=lambda ix: -len(ix.key_ids))
        for ix in composites:
            names = [self.schema.get_type(k).name for k in ix.key_ids]
            if not all(n in eq_keys for n in names):
                continue
            if set(names) <= covered:
                continue
            retrievals.append(("composite", ix,
                               tuple(eq_keys[n] for n in names)))
            covered |= set(names)

        # mixed cover for the remaining conditions
        remaining = [(k, p) for k, p in self._conditions
                     if k not in covered and p.op not in ("exists", "absent")]
        if remaining:
            graph = self.tx.graph
            for ix in candidates:
                if ix.composite:
                    continue
                provider = graph.index_provider(ix.backing)
                if provider is None:
                    continue
                names = {self.schema.get_type(k).name: (k, param)
                         for k, param in zip(ix.key_ids, ix.key_params)}
                cover = [(k, p) for k, p in remaining
                         if k in names and provider.supports(
                             self._keyinfo(*names[k]), p)]
                if cover:
                    retrievals.append(("mixed", ix, tuple(cover)))
                    covered |= {k for k, _ in cover}
                    remaining = [(k, p) for k, p in remaining
                                 if k not in covered]
                    if not remaining:
                        break

        if not retrievals:
            return None

        # execute + intersect (reference: processIntersectingRetrievals);
        # hits are normalized to {element id: payload} so composite-edge
        # (4-tuple) and mixed-edge retrievals intersect correctly
        result: Optional[dict] = None
        for kind, ix, payload in retrievals:
            hits = self._run_retrieval(kind, ix, payload, element)
            if result is None:
                result = hits
            else:
                result = {k: self._prefer(result[k], hits[k])
                          for k in result.keys() & hits.keys()}
            if not result:
                break
        return [result[k] for k in sorted(result or ())]

    @staticmethod
    def _prefer(a, b):
        """Keep the richer payload: a composite-edge 4-tuple reconstructs the
        edge directly, a mixed ("rel", id) hit needs a scan."""
        if isinstance(a, tuple) and len(a) == 4:
            return a
        return b if isinstance(b, tuple) and len(b) == 4 else a

    def _keyinfo(self, key_id: int, param: str = "DEFAULT"):
        from titan_tpu_torch.indexing.provider import KeyInformation
        st = self.schema.get_type(key_id)
        return KeyInformation(st.dtype, st.cardinality,
                              (param,) if param != "DEFAULT" else ())

    def _run_retrieval(self, kind: str, ix: IndexDefinition, payload,
                       element: str) -> dict:
        """→ {element id: payload} (vertex id, or relation id → edge hit)."""
        graph = self.tx.graph
        if kind == "composite":
            hits = graph.index_serializer.query_composite(
                self.tx.backend_tx, ix, payload)
            if element == "vertex":
                return {h: h for h in hits}
            return {h[0]: h for h in hits}
        from titan_tpu_torch.indexing.provider import (And, FieldCondition,
                                                       IndexQuery)
        cond = And(tuple(FieldCondition(k, p) for k, p in payload))
        itx = self.tx.backend_tx.index_txs.get(ix.backing)
        provider = graph.index_provider(ix.backing)
        docids = (itx or provider).query(ix.name, IndexQuery(cond))
        ser = graph.index_serializer
        if element == "vertex":
            return {(eid := ser.element_id_of(d)): eid for d in docids}
        return {(rid := ser.element_id_of(d)): ("rel", rid) for d in docids}

    # -- fallbacks / reconstruction ------------------------------------------

    def _full_scan(self, element: str) -> Iterator:
        log.warning("Query requires iterating over all %ss [%s] — consider "
                    "adding an index", element,
                    [k for k, _ in self._conditions])
        if element == "vertex":
            for v in self.tx.vertices():
                if self._matches(v):
                    yield v
            return
        seen = set()
        for v in self.tx.vertices():
            for e in v.edges(Direction.OUT):
                if e.id not in seen:
                    seen.add(e.id)
                    if self._matches(e):
                        yield e

    def _edge_from_hit(self, hit):
        """Rebuild an Edge from an index hit: (rel_id, out, in, type) from a
        composite index, or ("rel", rel_id) from a mixed one."""
        tx = self.tx
        if isinstance(hit, tuple) and hit and hit[0] == "rel":
            return self._edges_by_rel_ids({hit[1]}).get(hit[1])
        rel_id, out_vid, in_vid, type_id = hit
        if rel_id in tx._deleted:
            return None
        st = self.schema.get_type(type_id)
        if st is None:
            return None
        for e in tx.vertex_edges(out_vid, Direction.OUT, [st.name]):
            if e.id == rel_id:
                return e
        return None

    def _edges_by_rel_ids(self, rel_ids: set) -> dict:
        """Resolve relation ids to Edges with one pass over the edge store
        (mixed edge indexes key documents by relation id only)."""
        tx = self.tx
        wanted = {r for r in rel_ids if r not in tx._deleted}
        found: dict = {}
        if not wanted:
            return found
        for v in tx.vertices():
            for e in v.edges(Direction.OUT):
                if e.id in wanted:
                    found[e.id] = e
                    if len(found) == len(wanted):
                        return found
        return found

    def _tx_delta(self, element: str) -> Iterator:
        """Elements the committed indexes can't see: created in this tx OR
        with property changes in this tx (their index entries are stale)."""
        tx = self.tx
        if element == "vertex":
            seen = set()
            for vid in tx._new_vertices:
                if vid not in tx._removed_vertices:
                    seen.add(vid)
                    yield tx.vertex_handle(vid)
            for rel in list(tx._added.values()) + list(tx._deleted.values()):
                if not rel.is_property or \
                        self.schema.system.is_system(rel.type_id):
                    continue
                vid = rel.out_vertex_id
                if vid in seen or vid in tx._removed_vertices or \
                        not tx.idm.is_user_vertex_id(vid):
                    continue
                seen.add(vid)
                yield tx.vertex_handle(vid)
            return
        from titan_tpu_torch.core.elements import Edge
        for rel in tx._added.values():
            if rel.is_edge and not self.schema.system.is_system(rel.type_id):
                yield Edge(tx, rel)
