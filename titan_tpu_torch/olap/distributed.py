"""Distributed scan execution: ScanJobs over key splits in worker processes.

The Hadoop-analog tier (reference: titan-hadoop-core
scan/HadoopScanMapper.java:33-110 — any ScanJob runs as a Hadoop Mapper:
the job is reconstructed from serialized config in each mapper, every input
split re-slices its rows exactly like the in-process scanner, and
ScanMetrics map onto Hadoop counters; CassandraHadoopScanRunner /
HBaseHadoopScanRunner drive it; titan-test's SimpleScanJobRunner abstracts
"execute this ScanJob somehow" so one assertion suite runs both in-process
and distributed).

Input splits ARE the id-partition key ranges — partition bits sit in the
key MSBs (IDManager.key_of), so each split is one contiguous range that a
worker process scans independently against its own storage connection. No
Hadoop: workers are OS processes (the multi-host story runs one runner per
host over its local partition ranges).

Contract: the job is shipped as a ``ScanJobSpec`` — an importable factory
``module:callable`` called as ``factory(graph, **kwargs)`` in each worker —
mirroring HadoopScanMapper.setup's reconstruct-from-config, because live
jobs hold graph handles that cannot cross process boundaries.

The port's copy of ``titan_tpu/olap/distributed.py``. Its factories are
``titan_tpu_torch.olap.jobs:make_vertex_count_job`` and
``titan_tpu_torch.olap.distributed:make_repair_job``; a factory under the
JAX package or JAX is refused before any import
(``errors.refuse_foreign``). The scan path is host code: it touches no
device, so a split process never initialises CUDA.
"""

from __future__ import annotations

import importlib
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional, Sequence

from titan_tpu_torch.errors import refuse_foreign
from titan_tpu_torch.olap.api import ScanMetrics


@dataclass(frozen=True)
class ScanJobSpec:
    """Serializable job description: ``factory`` is ``"module:callable"``,
    invoked as ``factory(graph, **kwargs)`` inside each worker."""
    factory: str
    kwargs: dict = field(default_factory=dict)

    def build(self, graph):
        mod, _, fn = self.factory.partition(":")
        if not fn:
            raise ValueError(f"spec factory must be 'module:callable', "
                             f"got {self.factory!r}")
        refuse_foreign(self.factory, "scan job factory")
        return getattr(importlib.import_module(mod), fn)(graph, **self.kwargs)


def key_splits(idm, num_splits: int) -> list[tuple[bytes, bytes]]:
    """Contiguous key ranges covering the id space, aligned to partition
    boundaries (the key order is partition-major, so storage partitions are
    the natural input splits — the reference's region/token-range splits)."""
    num_partitions = idm.num_partitions
    num_splits = max(1, min(num_splits, num_partitions))
    per = num_partitions // num_splits
    extra = num_partitions % num_splits
    out = []
    p = 0
    for i in range(num_splits):
        width = per + (1 if i < extra else 0)
        start, _ = idm.partition_key_range(p)
        _, end = idm.partition_key_range(p + width - 1)
        out.append((start, end))
        p += width
    return out


def _merge_metrics(target: ScanMetrics, counts: dict) -> None:
    for k, v in counts.items():
        target.increment(k, v)


def _run_split(graph_config: dict, spec: ScanJobSpec,
               key_range: tuple, store: str, num_threads: int,
               attempts: int = 5) -> dict:
    """One worker: own graph connection, one key split, merged counters.
    Top-level so it pickles under the spawn start method. Retries on
    TemporaryBackendError (multi-process write contention during open or
    flush) — split work is idempotent, like re-run Hadoop mappers."""
    import random
    import time

    import titan_tpu_torch
    from titan_tpu_torch.errors import TemporaryBackendError
    from titan_tpu_torch.storage.scan import StandardScanner

    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            graph = titan_tpu_torch.open(dict(graph_config))
        except TemporaryBackendError as e:
            last = e
            time.sleep(0.05 * (2 ** attempt) * (1 + random.random()))
            continue
        try:
            job = spec.build(graph)
            backend = graph.backend
            st = backend.index_store if store == "graphindex" else \
                backend.edge_store
            scanner = StandardScanner(st.store, backend.manager)
            metrics = scanner.execute(job, graph=graph,
                                      num_threads=num_threads,
                                      key_range=key_range)
            return dict(metrics._counts)
        except TemporaryBackendError as e:
            last = e
            time.sleep(0.05 * (2 ** attempt) * (1 + random.random()))
        finally:
            graph.close()
    raise last  # type: ignore[misc]


class DistributedScanRunner:
    """Executes a ScanJobSpec over all key splits in separate OS processes,
    each with its own storage connection (requires a multi-process-capable
    backend, e.g. sqlite). The coordinator merges per-split ScanMetrics —
    the reference's counter aggregation across mappers."""

    def __init__(self, graph_config: dict, num_workers: int = 4,
                 store: str = "edgestore", threads_per_worker: int = 2):
        self.graph_config = dict(graph_config)
        self.num_workers = num_workers
        self.store = store
        self.threads_per_worker = threads_per_worker

    def run(self, spec: ScanJobSpec,
            idm=None) -> ScanMetrics:
        if idm is None:
            import titan_tpu_torch
            g = titan_tpu_torch.open(dict(self.graph_config))
            try:
                idm = g.idm
            finally:
                g.close()
        splits = key_splits(idm, self.num_workers)
        metrics = ScanMetrics()
        # spawn, never fork: the coordinator may hold a CUDA context and
        # sqlite threads — a forked child inherits a broken context, and
        # forking a multithreaded process deadlocks
        import multiprocessing as mp
        with ProcessPoolExecutor(max_workers=self.num_workers,
                                 mp_context=mp.get_context("spawn")) as pool:
            futures = [pool.submit(_run_split, self.graph_config, spec, r,
                                   self.store, self.threads_per_worker)
                       for r in splits]
            for f in futures:
                _merge_metrics(metrics, f.result())
        return metrics


class InProcessSplitRunner:
    """Same split contract, same assertions, no processes: scans each key
    split on a thread against a SHARED graph (titan-test's
    SimpleScanJobRunner duality — in-process vs distributed execution of
    the identical job). Works on every backend including inmemory."""

    def __init__(self, graph, num_workers: int = 4,
                 store: str = "edgestore"):
        self.graph = graph
        self.num_workers = num_workers
        self.store = store

    def run(self, spec: ScanJobSpec, idm=None) -> ScanMetrics:
        if not isinstance(spec, ScanJobSpec):
            # a live job instance would be SHARED by the worker threads —
            # concurrent setup()/process() on one stateful job corrupts it
            raise TypeError(
                "InProcessSplitRunner needs a ScanJobSpec (one job instance "
                "is built per split); got "
                f"{type(spec).__name__}")
        from titan_tpu_torch.storage.scan import StandardScanner
        graph = self.graph
        splits = key_splits(graph.idm, self.num_workers)
        backend = graph.backend
        st = backend.index_store if self.store == "graphindex" else \
            backend.edge_store
        scanner = StandardScanner(st.store, backend.manager)
        metrics = ScanMetrics()

        def one(key_range):
            job = spec.build(graph)
            m = scanner.execute(job, graph=graph, num_threads=1,
                                key_range=key_range)
            return dict(m._counts)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for counts in pool.map(one, splits):
                _merge_metrics(metrics, counts)
        return metrics


# ---------------------------------------------------------------------------
# distributed index management (MapReduceIndexManagement analog)
# ---------------------------------------------------------------------------

def make_repair_job(graph, index_name: str):
    """Worker-side factory for REINDEX (importable by ScanJobSpec)."""
    from titan_tpu_torch.indexing.jobs import IndexRepairJob
    idx = graph.management().get_graph_index(index_name)
    if idx is None:
        raise ValueError(f"unknown index {index_name!r}")
    return IndexRepairJob(graph, idx)


def distributed_reindex(graph_config: dict, index_name: str,
                        num_workers: int = 4) -> ScanMetrics:
    """Drive SchemaAction.REINDEX across worker processes (reference:
    titan-hadoop MapReduceIndexManagement.updateIndex:50-110 — REINDEX as
    an MR job over the edgestore). The caller is responsible for the
    REGISTER → REINDEX → ENABLE lifecycle transitions around it."""
    runner = DistributedScanRunner(graph_config, num_workers=num_workers)
    spec = ScanJobSpec("titan_tpu_torch.olap.distributed:make_repair_job",
                       {"index_name": index_name})
    return runner.run(spec)
