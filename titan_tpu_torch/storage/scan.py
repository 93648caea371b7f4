"""Parallel full-store scan runtime executing ScanJobs.

(reference: titan-core diskstorage/keycolumnvalue/scan/StandardScanner.java,
StandardScannerExecutor.java:85-335 — a DataPuller thread per slice query
feeds a bounded queue; N processor threads consume row-aligned bundles and
call ``job.process``; per-worker setup/teardown hooks; ScanMetrics counters.
Here a single ordered iteration drives row assembly (every backend we ship
is key-ordered) and rows are re-sliced per query exactly like
HadoopScanMapper does for distributed splits; processors run on a thread
pool.)
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
from typing import Optional

from titan_tpu_torch.olap.api import ScanJob, ScanMetrics
from titan_tpu_torch.storage.api import SliceQuery, apply_slice

log = logging.getLogger(__name__)

_POISON = object()


class StandardScanner:
    def __init__(self, store, manager):
        self._store = store
        self._manager = manager

    def execute(self, job: ScanJob, graph=None, config: Optional[dict] = None,
                num_threads: Optional[int] = None,
                queue_size: Optional[int] = None,
                block_size: Optional[int] = None,
                key_range: Optional[tuple] = None) -> ScanMetrics:
        """``key_range=(start, end)`` restricts the scan to one key split —
        the distributed runner's unit of work (reference: HadoopScanMapper
        processing one input split). Unset tuning params come from the
        graph's ``storage.scan.*`` options when a graph is supplied."""
        if graph is not None and hasattr(graph, "config"):
            from titan_tpu_torch.config import defaults as d
            num_threads = num_threads or graph.config.get(d.SCAN_THREADS)
            queue_size = queue_size or graph.config.get(d.SCAN_QUEUE_SIZE)
            block_size = block_size or graph.config.get(d.SCAN_BLOCK_SIZE)
        num_threads = num_threads or 4
        queue_size = queue_size or 1024
        block_size = block_size or 1000
        metrics = ScanMetrics()
        job.setup(graph, config or {}, metrics)
        queries = list(job.get_queries())
        if not queries:
            raise ValueError("scan job declares no queries")
        primary = queries[0]
        # covering slice: fetch once, re-slice per query
        starts = [q.start for q in queries]
        ends = [q.end for q in queries]
        cover = SliceQuery(min(starts),
                           None if any(e is None for e in ends) else max(ends))
        if key_range is not None:
            from titan_tpu_torch.storage.api import KeyRangeQuery
            scan_query = KeyRangeQuery(key_range[0], key_range[1], cover)
        else:
            scan_query = cover

        rows: _queue.Queue = _queue.Queue(maxsize=queue_size)
        errors: list[BaseException] = []

        def puller():
            txh = self._manager.begin_transaction()
            try:
                for key, entries in self._store.get_keys(scan_query, txh):
                    rows.put((key, entries))
            except BaseException as e:  # surface on the main thread
                errors.append(e)
            finally:
                txh.commit()
                for _ in range(num_threads):
                    rows.put(_POISON)

        def processor():
            failed = False
            processed = 0
            try:
                job.worker_iteration_start(config or {}, metrics)
            except BaseException as e:
                errors.append(e)
                failed = True
            try:
                while True:
                    item = rows.get()
                    if item is _POISON:
                        break
                    if failed:
                        continue  # keep DRAINING so the puller never blocks
                    try:
                        key, entries = item
                        by_query = {}
                        primary_empty = True
                        for q in queries:
                            sliced = apply_slice(entries, q)
                            by_query[q] = sliced
                            if q is primary and sliced:
                                primary_empty = False
                        if primary_empty:
                            continue  # row lacks the primary query → skip
                        try:
                            job.process(key, by_query, metrics)
                            metrics.increment(ScanMetrics.SUCCESS)
                        except Exception:
                            log.exception("scan job failed on row %r", key)
                            metrics.increment(ScanMetrics.FAILURE)
                        processed += 1
                        if processed % block_size == 0:
                            job.worker_iteration_end(metrics)
                            job.worker_iteration_start(config or {}, metrics)
                    except BaseException as e:  # slicing/iteration machinery
                        errors.append(e)
                        failed = True
            finally:
                try:
                    job.worker_iteration_end(metrics)
                except BaseException as e:
                    errors.append(e)

        pt = threading.Thread(target=puller, name="scan-puller", daemon=True)
        workers = [threading.Thread(target=processor, name=f"scan-proc-{i}",
                                    daemon=True) for i in range(num_threads)]
        pt.start()
        for w in workers:
            w.start()
        pt.join()
        for w in workers:
            w.join()
        if errors:
            raise errors[0]
        return metrics
