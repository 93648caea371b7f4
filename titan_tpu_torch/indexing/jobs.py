"""Index maintenance scan jobs: REINDEX backfill + index data removal.

(reference: titan-core graphdb/olap/job/IndexRepairJob.java — rebuilds a
single index by scanning every element and re-emitting its index entries;
IndexRemoveJob.java — deletes an index's rows from the graphindex store (or
its documents from the mixed provider); both run under SchemaAction via
ManagementSystem.updateIndex and report progress through ScanMetrics.)
"""

from __future__ import annotations

from titan_tpu_torch.core.defs import Direction, RelationCategory
from titan_tpu_torch.olap.api import ScanJob, ScanMetrics
from titan_tpu_torch.storage.api import Entry, SliceQuery
from titan_tpu_torch.storage.scan import StandardScanner

ADDED = "index-entries-added"
REMOVED = "index-rows-removed"
_FLUSH = 1000


class IndexRepairJob(ScanJob):
    """Scan the edgestore and (re)write every entry of ONE index."""

    def __init__(self, graph, index):
        self.graph = graph
        self.index = index
        self.ser = graph.index_serializer
        self.schema = graph.schema
        self._all = SliceQuery()
        self._pending_rows: list = []      # composite: (row_key, Entry)
        self._pending_docs: dict = {}      # mixed: docid -> {field: value}

    def get_queries(self):
        return [self._all]

    def process(self, key: bytes, entries_by_query: dict,
                metrics: ScanMetrics) -> None:
        entries = entries_by_query[self._all]
        if not entries:
            return
        eid = self.graph.idm.id_of_key_bytes(key)
        if self.index.element == "vertex":
            self._process_vertex(eid, entries, metrics)
        else:
            self._process_edges(eid, entries, metrics)

    def _process_vertex(self, vid: int, entries, metrics) -> None:
        if not self.graph.idm.is_user_vertex_id(vid):
            return
        values: dict[int, list] = {}
        alive = False
        for e in entries:
            rc = self.graph.codec.parse(e, self.schema)
            if rc.type_id == self.schema.system.vertex_exists:
                alive = True
            if rc.category is RelationCategory.PROPERTY and \
                    rc.type_id in self.index.key_ids:
                values.setdefault(rc.type_id, []).append(rc.value)
        if not alive:
            return
        if any(k not in values for k in self.index.key_ids):
            return   # all-keys-present rule
        if self.index.composite:
            from itertools import product
            if len(self.index.key_ids) > 1 and \
                    any(len(v) > 1 for v in values.values()):
                # the live write path rejects multi-valued keys on multi-key
                # composite indexes — don't backfill rows it can't maintain
                metrics.increment(ScanMetrics.FAILURE)
                return
            col = self.ser.vertex_column(vid)
            for vals in product(*(values[k] for k in self.index.key_ids)):
                row = self.ser.composite_row_key(self.index, vals)
                self._pending_rows.append((row, Entry(col, b"")))
                metrics.increment(ADDED)
        else:
            doc = {}
            for kid in self.index.key_ids:
                name = self.schema.get_type(kid).name
                vals = values[kid]
                doc[name] = vals[0] if len(vals) == 1 else list(vals)
            self._pending_docs[self.ser.docid_for(vid)] = doc
            metrics.increment(ADDED)

    def _process_edges(self, vid: int, entries, metrics) -> None:
        for e in entries:
            rc = self.graph.codec.parse(e, self.schema)
            if rc.category is not RelationCategory.EDGE or \
                    rc.direction is not Direction.OUT:
                continue   # each edge indexes once, from its OUT row
            if self.schema.system.is_system(rc.type_id):
                continue
            if self.index.index_only and rc.type_id != self.index.index_only:
                continue
            vals = []
            for kid in self.index.key_ids:
                if kid not in rc.properties:
                    break
                vals.append(rc.properties[kid])
            else:
                if self.index.composite:
                    row = self.ser.composite_row_key(self.index, vals)

                    class _R:   # edge_column needs the relation view
                        relation_id = rc.relation_id
                        out_vertex_id = vid
                        in_vertex_id = rc.other_vertex_id
                        type_id = rc.type_id
                    self._pending_rows.append(
                        (row, Entry(self.ser.edge_column(_R), b"")))
                else:
                    doc = {self.schema.get_type(k).name: v
                           for k, v in zip(self.index.key_ids, vals)}
                    self._pending_docs[self.ser.docid_for(rc.relation_id)] = doc
                metrics.increment(ADDED)

    def worker_iteration_end(self, metrics: ScanMetrics) -> None:
        if self._pending_rows:
            batch, self._pending_rows = self._pending_rows, []
            backend = self.graph.backend
            txh = backend.manager.begin_transaction()
            try:
                for row, entry in batch:
                    backend.index_store.store.mutate(row, [entry], [], txh)
                    backend.index_store.invalidate(row)
                txh.commit()
            except BaseException:
                txh.rollback()
                raise
        if self._pending_docs:
            docs, self._pending_docs = self._pending_docs, {}
            provider = self.graph.index_provider(self.index.backing)
            from titan_tpu_torch.indexing.provider import IndexMutation
            provider.mutate({self.index.name: {
                docid: IndexMutation(additions=doc)
                for docid, doc in docs.items()}})


class IndexRemoveJob(ScanJob):
    """Delete every row of ONE composite index from the graphindex store
    (scans the graphindex store itself, keyed by the index-id prefix)."""

    def __init__(self, graph, index):
        self.graph = graph
        self.index = index
        from titan_tpu_torch.codec.dataio import DataOutput
        out = DataOutput()
        out.put_uvar(index.id)
        self._prefix = out.getvalue()
        self._all = SliceQuery()
        self._pending: list = []

    def get_queries(self):
        return [self._all]

    def process(self, key: bytes, entries_by_query: dict,
                metrics: ScanMetrics) -> None:
        if not key.startswith(self._prefix):
            return
        cols = [e.column for e in entries_by_query[self._all]]
        if cols:
            self._pending.append((key, cols))
            metrics.increment(REMOVED)

    def worker_iteration_end(self, metrics: ScanMetrics) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        backend = self.graph.backend
        txh = backend.manager.begin_transaction()
        try:
            for key, cols in batch:
                backend.index_store.store.mutate(key, [], cols, txh)
                backend.index_store.invalidate(key)
            txh.commit()
        except BaseException:
            txh.rollback()
            raise


def reindex(graph, index, num_threads: int = 2) -> ScanMetrics:
    """Backfill an index from existing data (SchemaAction.REINDEX)."""
    if not index.composite:
        provider = graph.index_provider(index.backing)
        if provider is not None:   # replay field registrations
            graph.index_serializer.register_keys(provider, index)
    scanner = StandardScanner(graph.backend.edge_store.store,
                              graph.backend.manager)
    return scanner.execute(IndexRepairJob(graph, index), graph,
                           num_threads=num_threads)


def remove_index_data(graph, index, num_threads: int = 2) -> ScanMetrics:
    """Drop an index's stored data (SchemaAction.REMOVE_INDEX)."""
    if index.composite:
        scanner = StandardScanner(graph.backend.index_store.store,
                                  graph.backend.manager)
        return scanner.execute(IndexRemoveJob(graph, index), graph,
                               num_threads=num_threads)
    provider = graph.index_provider(index.backing)
    if provider is not None:
        provider.drop_store(index.name)
    return ScanMetrics()
