"""Vertex-centric query builder.

(reference: titan-core graphdb/query/vertex/BasicVertexCentricQueryBuilder.java:719
— builds sliced adjacency queries: relation type + direction + sort-key
interval become column ranges (via EdgeSerializer.getQuery), everything else
becomes an in-memory filter; merges stored results with the transaction's
in-memory delta. ``interval()`` on the label's FIRST sort key narrows the
slice server-side — the vertex-centric-index fast path.)

The port's copy of ``titan_tpu/query/vertexquery.py``, over the port's
``storage/api.KeySliceQuery``.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

from titan_tpu_torch.core.defs import Direction
from titan_tpu_torch.core.elements import Edge, VertexProperty
from titan_tpu_torch.query.predicates import P
from titan_tpu_torch.storage.api import KeySliceQuery


class VertexCentricQueryBuilder:
    def __init__(self, tx, vertex_id: int):
        self._tx = tx
        self._vid = vertex_id
        self._labels: Optional[list[str]] = None
        self._direction = Direction.BOTH
        self._limit: Optional[int] = None
        self._interval: Optional[tuple] = None   # (key_name, lo, hi)
        self._filters: list[tuple] = []          # (key_name, P)

    def labels(self, *names: str) -> "VertexCentricQueryBuilder":
        self._labels = list(names)
        return self

    def direction(self, d: Direction) -> "VertexCentricQueryBuilder":
        self._direction = d
        return self

    def interval(self, key: str, lo: Any, hi: Any) -> "VertexCentricQueryBuilder":
        """[lo, hi) on a sort-key property → server-side column range."""
        self._interval = (key, lo, hi)
        return self

    def has(self, key: str, value: Any) -> "VertexCentricQueryBuilder":
        pred = value if isinstance(value, P) else P.eq(value)
        self._filters.append((key, pred))
        return self

    def limit(self, n: int) -> "VertexCentricQueryBuilder":
        self._limit = n
        return self

    # -- execution -----------------------------------------------------------

    def _sort_key_bounds(self, label_id: int):
        """If the interval targets the label's first sort key, return
        (sort_start, sort_end) lists for the codec slice."""
        if self._interval is None:
            return None, None
        key_name, lo, hi = self._interval
        st = self._tx.schema.get_by_name(key_name)
        sort = self._tx.schema.sort_key(label_id)
        if st is not None and sort and sort[0] == st.id:
            return [lo], [hi]
        return None, None

    def edges(self) -> Iterator[Edge]:
        tx = self._tx
        label_ids = None
        if self._labels is not None:
            label_ids = [st.id for n in self._labels
                         if (st := tx.schema.get_by_name(n)) is not None]
            if not label_ids:
                return
        count = 0
        emitted = set()
        if self._vid not in tx._new_vertices and label_ids is not None:
            for lid in label_ids:
                sort_start, sort_end = self._sort_key_bounds(lid)
                # the interval is server-side iff it was folded into the slice
                interval_pushed = sort_start is not None or self._interval is None
                for q in tx.codec.query_type(lid, self._direction, tx.schema,
                                             sort_start=sort_start,
                                             sort_end=sort_end):
                    # only push the limit down when no client-side check can
                    # reject rows (filters, unpushed intervals, OR tx-deleted
                    # relations — all would make the slice under-return)
                    if self._limit is not None and not self._filters and \
                            interval_pushed and not tx._deleted:
                        q = q.with_limit(self._limit)
                    for entry in tx.backend_tx.edge_store_query(
                            KeySliceQuery(tx.idm.key_bytes(self._vid), q)):
                        rc = tx.codec.parse(entry, tx.schema)
                        rel = tx._relation_from_cache(self._vid, rc)
                        if rel.relation_id in tx._deleted:
                            continue
                        e = Edge(tx, rel)
                        if self._accept(e):
                            k = (rel.relation_id, rc.direction)
                            if k in emitted:
                                continue
                            emitted.add(k)
                            yield e
                            count += 1
                            if self._limit is not None and count >= self._limit:
                                return
        else:
            for e in tx.vertex_edges(self._vid, self._direction, self._labels):
                if self._accept(e):
                    yield e
                    count += 1
                    if self._limit is not None and count >= self._limit:
                        return
            return
        # in-tx additions
        for rel in tx._added_by_vertex.get(self._vid, ()):
            if not rel.is_edge or (label_ids and rel.type_id not in label_ids):
                continue
            if self._direction is not Direction.BOTH and \
                    rel.direction_of(self._vid) is not self._direction:
                continue
            e = Edge(tx, rel)
            if self._accept(e):
                yield e
                count += 1
                if self._limit is not None and count >= self._limit:
                    return

    def _accept(self, e: Edge) -> bool:
        if self._interval is not None:
            key, lo, hi = self._interval
            v = e.value(key)
            if v is None or not (lo <= v < hi):
                return False
        for key, pred in self._filters:
            v = e.value(key)
            if v is None or not pred(v):
                return False
        return True

    def vertices(self):
        me = self._tx.vertex_handle(self._vid)
        for e in self.edges():
            yield e.other(me)

    def properties(self) -> Iterator[VertexProperty]:
        it = self._tx.vertex_properties(self._vid, self._labels)
        count = 0
        for p in it:
            ok = True
            for key, pred in self._filters:
                if p.key() != key or not pred(p.value):
                    ok = False
                    break
            if ok:
                yield p
                count += 1
                if self._limit is not None and count >= self._limit:
                    return

    def count(self) -> int:
        return sum(1 for _ in self.edges())
