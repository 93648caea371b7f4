"""System maintenance scan jobs.

(reference: titan-core graphdb/olap/job/GhostVertexRemover.java — removes
half-deleted "ghost" vertices left by races on eventually-consistent stores:
rows that still carry relations but lost their vertex-exists marker;
IndexRepairJob/IndexRemoveJob live with the index lifecycle in
indexing/jobs.py.)
"""

from __future__ import annotations

from titan_tpu_torch.core.defs import Direction
from titan_tpu_torch.olap.api import ScanJob, ScanMetrics
from titan_tpu_torch.storage.api import SliceQuery


class GhostVertexRemover(ScanJob):
    REMOVED = "ghost-removed"

    def __init__(self, graph):
        self.graph = graph
        [self._exists_q] = graph.codec.query_type(
            graph.schema.system.vertex_exists, Direction.OUT, graph.schema)
        self._all_q = SliceQuery()
        self._pending: list[tuple[bytes, list]] = []

    def get_queries(self):
        # primary = full row; the existence check re-slices it
        return [self._all_q]

    def process(self, key: bytes, entries_by_query: dict, metrics: ScanMetrics):
        entries = entries_by_query[self._all_q]
        if not entries:
            return
        vid = self.graph.idm.id_of_key_bytes(key)
        if not self.graph.idm.is_user_vertex_id(vid):
            return
        if any(self._exists_q.contains(e.column) for e in entries):
            return  # alive
        # ghost: relations without existence — delete everything in the row
        self._pending.append((key, [e.column for e in entries]))
        metrics.increment(self.REMOVED)

    def worker_iteration_end(self, metrics: ScanMetrics):
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        backend = self.graph.backend
        txh = backend.manager.begin_transaction()
        try:
            for key, columns in batch:
                backend.edge_store.store.mutate(key, [], columns, txh)
                backend.edge_store.invalidate(key)
            txh.commit()
        except BaseException:
            txh.rollback()
            raise


class VertexCountJob(ScanJob):
    """Counts live user vertices and their OUT edges — the smallest useful
    ScanJob, and the shared fixture for the split-runner suites (reference:
    titan-test diskstorage/SimpleScanJob.java:25 — the configurable job run
    both in-process and on MapReduce)."""

    VERTICES = "vertex-count"
    EDGES = "edge-count"

    def __init__(self, graph):
        self.graph = graph
        [self._exists_q] = graph.codec.query_type(
            graph.schema.system.vertex_exists, Direction.OUT, graph.schema)
        self._all_q = SliceQuery()

    def get_queries(self):
        return [self._all_q, self._exists_q]

    def process(self, key: bytes, entries_by_query: dict,
                metrics: ScanMetrics) -> None:
        from titan_tpu_torch.core.defs import RelationCategory
        vid = self.graph.idm.id_of_key_bytes(key)
        if not self.graph.idm.is_user_vertex_id(vid):
            return
        if not entries_by_query[self._exists_q]:
            return
        metrics.increment(self.VERTICES)
        for e in entries_by_query[self._all_q]:
            rc = self.graph.codec.parse(e, self.graph.schema)
            if rc.category is RelationCategory.EDGE and \
                    rc.direction is Direction.OUT and \
                    not self.graph.schema.system.is_system(rc.type_id):
                metrics.increment(self.EDGES)


def make_vertex_count_job(graph):
    """Worker-side factory for the split runners (ScanJobSpec target)."""
    return VertexCountJob(graph)


def remove_ghost_vertices(graph, num_threads: int = 2) -> int:
    """Run the ghost remover over the edgestore; returns vertices removed."""
    from titan_tpu_torch.storage.scan import StandardScanner
    job = GhostVertexRemover(graph)
    metrics = StandardScanner(graph.backend.edge_store.store,
                              graph.backend.manager).execute(
        job, graph=graph, num_threads=num_threads)
    return metrics.get(GhostVertexRemover.REMOVED)
