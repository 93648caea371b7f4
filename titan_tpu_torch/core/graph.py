"""StandardGraph: graph lifetime and the commit orchestration.

(reference: titan-core graphdb/database/StandardTitanGraph.java:78-808 —
opens the Backend, builds serializers/caches/id-assigner, registers the
instance, and hosts the commit path that turns a transaction's deltas into
batched per-row store mutations.)

The port's copy of ``titan_tpu/core/graph.py``. ``metrics.enabled`` counts
transactions in the port's ``MetricManager`` and starts its scheduled
reporters (``utils/metrics.py``), stopped at ``close()``; the Backend
instruments the stores. ``traversal()`` is the port's dsl and ``query()``
its graph-centric query; ``compute()`` runs the port's ``GPUGraphComputer``
(``backend="gpu"``, the default) or ``HostGraphComputer``
(``backend="host"``); the mixed-index providers are the port's
``memindex``, ``lucene``/``fts`` and ``remote-index``.
"""

from __future__ import annotations

import os
import threading
import uuid as _uuid
from typing import Optional

from titan_tpu_torch.codec.attributes import Serializer
from titan_tpu_torch.codec.edges import EdgeCodec
from titan_tpu_torch.config import (Configuration, MapConfiguration, defaults as d)
from titan_tpu_torch.core.defs import Direction, RelationCategory
from titan_tpu_torch.core.schema import SchemaManager
from titan_tpu_torch.core.tx import GraphTransaction
from titan_tpu_torch.errors import (ConfigurationError, TitanError,
                                    refuse_foreign)
from titan_tpu_torch.ids import IDManager
from titan_tpu_torch.ids.assigner import IDAssigner
from titan_tpu_torch.storage.api import Entry
from titan_tpu_torch.storage.backend import Backend


class StandardGraph:
    def __init__(self, config: Configuration):
        self.local_config = config
        self.instance_id = config.get(d.UNIQUE_INSTANCE_ID) or \
            f"{os.getpid()}-{_uuid.uuid4().hex[:8]}"
        self.backend = Backend(config, instance_id=self.instance_id)

        # merge cluster-global config stored IN the backend with the local
        # file: GLOBAL/FIXED options are authoritative from the store;
        # first opener initializes them from its local values (reference:
        # GraphDatabaseConfiguration ctor + KCVSConfiguration)
        from titan_tpu_torch.config import (Configuration as _Cfg,
                                      MergedConfiguration,
                                      ModifiableConfiguration, Restriction)
        global_raw = self.backend.global_config_store
        if global_raw.get("cluster.frozen") is None:
            init = ModifiableConfiguration(d.ROOT, global_raw)
            init.set(d.MAX_PARTITIONS, config.get(d.MAX_PARTITIONS), force=True)
            init.set(d.TIMESTAMP_PROVIDER, config.get(d.TIMESTAMP_PROVIDER),
                     force=True)
            global_raw.set("cluster.frozen", True)
        self.config = MergedConfiguration(
            config, _Cfg(d.ROOT, global_raw))
        config = self.config

        # the backend was built from the LOCAL config; FIXED options from the
        # global store are authoritative — re-align the timestamp provider
        # (drives lock claims and log ordering across instances)
        self.backend.set_timestamp_provider(config.get(d.TIMESTAMP_PROVIDER))

        self.backend.instance_registry.register(self.instance_id)
        self.idm = IDManager(
            partition_bits=(config.get(d.MAX_PARTITIONS)).bit_length() - 1)
        self.serializer = Serializer()
        self.codec = EdgeCodec(self.serializer, self.idm)

        # snapshot freshness: monotone commit counter + in-process change
        # listeners (OLAP snapshots subscribe so refresh() can apply
        # deltas without re-scanning the store; the reference instead
        # re-scans live data every OLAP run — StandardScannerExecutor).
        # Held WEAKLY: a snapshot dropped without close() auto-unregisters
        # instead of accumulating payloads forever.
        import weakref
        self._mutation_epoch = 0
        self._change_listeners: "weakref.WeakValueDictionary" = \
            weakref.WeakValueDictionary()
        self._listener_seq = 0

        # WAL (reference: tx.log-tx → txlog writes in the commit path)
        self._wal = None
        if config.get(d.LOG_TX):
            from titan_tpu_torch.core.wal import TransactionLog
            self._wal = TransactionLog(
                self.backend.log_manager.open_log(config.get(d.TX_LOG_NAME)),
                self.serializer)
        self.id_assigner = IDAssigner(
            self.idm, self.backend.id_authority,
            block_size=config.get(d.IDS_BLOCK_SIZE),
            renew_percentage=config.get(d.IDS_RENEW_PERCENTAGE))
        self.schema = SchemaManager(self)
        from titan_tpu_torch.indexing.serializer import IndexSerializer
        self.index_serializer = IndexSerializer(self.serializer, self.idm,
                                                self.schema)
        self.auto_schema = True
        self.allow_custom_vid = config.get(d.ALLOW_SETTING_VERTEX_ID)
        self._open = True
        self._tlocal = threading.local()
        self._index_providers: dict = {}   # name -> IndexProvider
        try:
            for name in config.container_names(d.INDEX_NS):
                self._open_index_provider(name)
        except Exception:
            # ANY raising provider open (ConfigurationError, a bad
            # import path, ...) must not leak the already-opened storage
            # backend or leave a ghost entry in the instance registry
            try:
                self.backend.instance_registry.deregister(self.instance_id)
            except Exception:   # noqa: BLE001 — best-effort cleanup
                pass
            try:
                self.backend.close()
            except Exception:   # noqa: BLE001
                pass
            self._open = False
            raise
        self._commit_lock = threading.Lock()
        self._metrics = None
        self._metrics_prefix = config.get(d.METRICS_PREFIX) or "titan_tpu"
        self._reporters = []
        if config.get(d.BASIC_METRICS):
            from titan_tpu_torch.utils.metrics import (MetricManager,
                                                       start_reporters)
            self._metrics = MetricManager.instance()
            # periodic background reporters (console/CSV/Graphite), each
            # gated on its interval option; stopped at close(). Only
            # started when collection is on — a reporter without
            # metrics.enabled would dump empty (or another graph's)
            # snapshots from the shared registry forever. Startup is
            # deduped per (manager, sink): two graphs with the same
            # reporter config share one refcounted reporter thread, so
            # neither emits a duplicate stream and closing one graph
            # doesn't silence the other
            self._reporters = start_reporters(config, self._metrics)

    # -- mixed index providers ----------------------------------------------

    def _open_index_provider(self, name: str):
        from titan_tpu_torch.config import defaults as d
        backend = self.config.get(d.INDEX_BACKEND, name)
        directory = self.config.get(d.INDEX_DIRECTORY, name)
        if backend in ("lucene", "fts"):
            # embedded persistent full-text engine (the Lucene-role provider)
            from titan_tpu_torch.indexing.ftsindex import FTSIndex
            provider = FTSIndex(name, directory or None)
        elif backend == "remote-index":
            # networked index node (the ES/Solr role)
            from titan_tpu_torch.indexing.remote import RemoteIndexProvider
            hosts = self.config.get(d.INDEX_HOSTNAME, name) or []
            provider = RemoteIndexProvider(
                name, hostname=hosts[0] if hosts else "127.0.0.1",
                port=self.config.get(d.INDEX_PORT, name) or 8284)
        elif backend in ("elasticsearch", "solr"):
            # honesty over convenience: these names promise a CLUSTER
            # index (reference: StandardIndexProvider maps them to real
            # providers) — silently handing back the in-process
            # MemoryIndex would give a user a non-durable per-process
            # index while they believe they attached a cluster
            raise ConfigurationError(
                f"index.{name}.backend={backend!r} names a cluster index "
                "this build does not embed; use backend=remote-index "
                "pointing at a `python -m titan_tpu_torch.indexing.remote` "
                "node (the ES/Solr-role networked provider), "
                "backend=lucene for the embedded full-text engine, or "
                "backend=memindex for an explicit in-process index")
        elif backend == "memindex":
            from titan_tpu_torch.indexing.memindex import MemoryIndex
            provider = MemoryIndex(name, directory or None)
        else:
            import importlib
            refuse_foreign(backend, f"index.{name}.backend")
            mod, _, cls = backend.rpartition(".")
            provider = getattr(importlib.import_module(mod), cls)(
                name, directory or None)
        self._index_providers[name] = provider
        return provider

    def index_provider(self, name: str):
        """Provider by config name; opens on demand so an index built before
        the provider was configured still resolves."""
        p = self._index_providers.get(name)
        if p is None and name:
            try:
                p = self._open_index_provider(name)
            except ConfigurationError:
                raise          # misconfiguration must not degrade to None
            except Exception:
                return None
        return p

    # -- transactions --------------------------------------------------------

    def new_transaction(self, read_only: bool = False,
                        log_identifier: Optional[str] = None
                        ) -> GraphTransaction:
        self._check_open()
        self.count_tx("begin")
        return GraphTransaction(self, read_only=read_only,
                                log_identifier=log_identifier)

    def count_tx(self, event: str) -> None:
        """tx begin/commit/rollback counters (reference: docs/monitoring.txt:7-12
        measured domains; counters live in the shared MetricManager)."""
        if self._metrics is not None:
            self._metrics.counter(f"{self._metrics_prefix}.tx.{event}").inc()

    def tx(self) -> GraphTransaction:
        """Thread-bound current transaction (reference: thread-bound tx in
        TitanBlueprintsGraph)."""
        cur = getattr(self._tlocal, "tx", None)
        if cur is None or not cur.is_open:
            cur = self.new_transaction()
            self._tlocal.tx = cur
        return cur

    def traversal(self):
        from titan_tpu_torch.traversal.dsl import GraphTraversalSource
        return GraphTraversalSource(self)

    def open_index_txs(self) -> dict:
        return {name: provider.begin_transaction()
                for name, provider in self._index_providers.items()}

    # -- convenience (delegate to the thread tx) ----------------------------

    def add_vertex(self, label: Optional[str] = None, **props):
        return self.tx().add_vertex(label, **props)

    def vertex(self, vid: int):
        return self.tx().vertex(vid)

    def vertices(self):
        return self.tx().vertices()

    def query(self):
        """Graph-centric query (reference: TitanGraph.query())."""
        return self.tx().query()

    def index_query(self, index_name: str, raw: str, limit=None, offset=0):
        """Direct native query against a mixed index (reference:
        TitanGraph.indexQuery → IndexQueryBuilder). Yields (element, score)."""
        from titan_tpu_torch.core.schema import IndexDefinition
        from titan_tpu_torch.indexing.provider import RawQuery
        st = self.schema.get_by_name(index_name)
        if not isinstance(st, IndexDefinition) or st.composite:
            raise TitanError(f"{index_name!r} is not a mixed index")
        provider = self.index_provider(st.backing)
        if provider is None:
            raise TitanError(f"provider {st.backing!r} not configured")
        tx = self.tx()
        out = []
        hits = provider.raw_query(index_name,
                                  RawQuery(raw, limit=limit, offset=offset))
        if st.element == "vertex":
            for docid, score in hits:
                el = tx.vertex(self.index_serializer.element_id_of(docid))
                if el is not None:
                    out.append((el, score))
            return out
        from titan_tpu_torch.query.graphquery import GraphQuery
        eids = [self.index_serializer.element_id_of(d) for d, _ in hits]
        rel_map = GraphQuery(tx)._edges_by_rel_ids(set(eids))
        for (docid, score), eid in zip(hits, eids):
            el = rel_map.get(eid)
            if el is not None:
                out.append((el, score))
        return out

    def commit(self):
        cur = getattr(self._tlocal, "tx", None)
        if cur is not None and cur.is_open:
            cur.commit()
        self._tlocal.tx = None

    def rollback(self):
        cur = getattr(self._tlocal, "tx", None)
        if cur is not None and cur.is_open:
            cur.rollback()
        self._tlocal.tx = None

    # -- management ----------------------------------------------------------

    def management(self):
        from titan_tpu_torch.core.management import ManagementSystem
        return ManagementSystem(self)

    def compute(self, backend: Optional[str] = None, **kwargs):
        """The graph computer (``olap.graph_computer``): ``backend="gpu"``
        (the default) is ``GPUGraphComputer`` over snapshots built from
        this graph; ``kwargs`` go to it (``device="cpu"`` in tests)."""
        from titan_tpu_torch.olap import graph_computer
        return graph_computer(
            self, backend or self.config.get(d.COMPUTER_BACKEND), **kwargs)

    # -- commit orchestration (reference: StandardTitanGraph.commit) ---------

    def commit_transaction(self, tx: GraphTransaction) -> None:
        additions: dict[bytes, list] = {}
        deletions: dict[bytes, list] = {}
        # (vertex row, column) -> expected old value, for LOCK-consistency
        lock_targets: dict[tuple, Optional[bytes]] = {}

        # vertex-label TTLs: every cell of a TTL'd STATIC-label vertex
        # expires together (reference: prepareCommit TTL metadata,
        # StandardTitanGraph.java:558-592; vertex TTL requires static labels)
        label_ttl: dict[int, float] = {}
        for vid, lid in tx._vertex_labels.items():
            if lid:
                st = self.schema.get_type(lid)
                t = getattr(st, "ttl", 0.0) if st is not None else 0.0
                if t > 0:
                    label_ttl[vid] = t

        def entry_with_ttl(rel, entry: Entry) -> Entry:
            from titan_tpu_torch.storage.api import TTLEntry
            ttls = [self.schema.ttl_of(rel.type_id)]
            ttls.append(label_ttl.get(rel.out_vertex_id, 0.0))
            if rel.is_edge:
                ttls.append(label_ttl.get(rel.in_vertex_id, 0.0))
            live = [t for t in ttls if t > 0]
            if not live:
                return entry
            return TTLEntry(entry.column, entry.value, min(live))

        def add(vid: int, entry: Entry):
            additions.setdefault(self.idm.key_bytes(vid), []).append(entry)

        def delete(vid: int, column: bytes):
            deletions.setdefault(self.idm.key_bytes(vid), []).append(column)

        # deleted relations first (an added SINGLE property both deletes the
        # old entry and writes the new one on the same column — consolidation
        # in the mutator keeps the addition; reference: prepareCommit order)
        for rel in tx._deleted.values():
            locked = self._needs_lock(rel)
            for vid, entry in self._serialize(rel):
                delete(vid, entry.column)
                if locked:
                    lock_targets[(self.idm.key_bytes(vid), entry.column)] = \
                        entry.value
        for rel in tx._added.values():
            locked = self._needs_lock(rel)
            for vid, entry in self._serialize(rel):
                add(vid, entry_with_ttl(rel, entry))
                if locked:
                    lock_targets.setdefault(
                        (self.idm.key_bytes(vid), entry.column), None)

        # index updates implied by this tx (reference: prepareCommit collects
        # IndexUpdates per mutation, IndexSerializer.getIndexUpdates)
        index_updates = self.index_serializer.collect_updates(tx)
        idx_additions: dict[bytes, list] = {}
        idx_deletions: dict[bytes, list] = {}
        unique_adds: list = []            # (row_key, column) to enforce
        mixed_updates: list = []
        for u in index_updates:
            if u.key is None:
                mixed_updates.append(u)
                continue
            if u.addition:
                idx_additions.setdefault(u.key, []).append(u.entry)
                if u.index.unique:
                    unique_adds.append((u.key, u.entry.column))
            else:
                idx_deletions.setdefault(u.key, []).append(u.entry.column)

        btx = tx.backend_tx
        for u in mixed_updates:   # buffered; flushed by commit_indexes
            itx = btx.index_txs.get(u.index.backing)
            if itx is None:
                # the backend tx may have snapshotted index_txs before this
                # provider was (lazily) opened — attach a fresh provider tx
                provider = self.index_provider(u.index.backing)
                if provider is None:
                    raise TitanError(
                        f"mixed index {u.index.name!r} needs provider "
                        f"{u.index.backing!r} — configure "
                        f"index.{u.index.backing}.backend")
                itx = btx.index_txs.setdefault(u.index.backing,
                                               provider.begin_transaction())
            if u.addition:
                itx.add(u.index.name, u.docid, u.field, u.value)
            else:
                itx.delete(u.index.name, u.docid, u.field)
        locker = self.backend.locker
        lock_state = tx._lock_state
        try:
            if lock_targets and locker is not None:
                from titan_tpu_torch.storage.locking import LockID
                for (key, column), expected in lock_targets.items():
                    lid = LockID("edgestore", key, column)
                    lock_state.expected.setdefault(lid, expected)
                    locker.write_lock(lid, lock_state)
            if unique_adds and locker is not None:
                from titan_tpu_torch.storage.locking import LockID
                for row_key, _col in unique_adds:
                    lid = LockID("graphindex", row_key, b"\x00u")
                    lock_state.expected.setdefault(lid, None)
                    locker.write_lock(lid, lock_state)

            wal, txid = self._wal, None
            if wal is not None:
                txid = wal.next_txid()
                payload = {
                    "edgestore": {key: ([tuple(e) for e in additions.get(key, [])],
                                        list(deletions.get(key, [])))
                                  for key in set(additions) | set(deletions)}}
                if idx_additions or idx_deletions:
                    payload["graphindex"] = {
                        key: ([tuple(e) for e in idx_additions.get(key, [])],
                              list(idx_deletions.get(key, [])))
                        for key in set(idx_additions) | set(idx_deletions)}
                wal.log_precommit(txid, payload)

            with self._commit_lock:
                if lock_state.has_locks and locker is not None:
                    locker.check_locks(lock_state, self._read_current_value)
                self._check_unique(unique_adds, idx_deletions)
                for key in set(additions) | set(deletions):
                    btx.mutate_edges(
                        key,
                        additions.get(key, ()),
                        deletions.get(key, ()))
                for key in set(idx_additions) | set(idx_deletions):
                    btx.mutate_index(
                        key,
                        idx_additions.get(key, ()),
                        idx_deletions.get(key, ()))
                try:
                    btx.commit_storage()
                except BaseException:
                    btx.rollback()
                    raise
                # WAL primary-success IMMEDIATELY after the storage
                # commit: a crash while building/pushing change payloads
                # below must not leave a durable commit classified by
                # TransactionRecovery as "failed before storage commit"
                if wal is not None:
                    wal.log_primary_success(txid)
                # storage is durable: feed subscribed snapshots their
                # delta, THEN bump the epoch — in the SAME lock block as
                # commit_storage, so storage visibility and epoch order
                # are atomic. (If the lock were dropped between the two,
                # a snapshot build() scanning in the gap would see the
                # edge in storage AND later receive its payload with an
                # epoch > epoch0, double-applying it through refresh()'s
                # continuity check.)
                epoch_next = self._mutation_epoch + 1
                listeners = list(self._change_listeners.values())
                if listeners:
                    from titan_tpu_torch.core.changes import change_payload
                    payload = change_payload(self, tx,
                                             txid if txid is not None
                                             else epoch_next)
                    payload["epoch"] = epoch_next
                    for q in listeners:
                        q.push(payload)
                self._mutation_epoch = epoch_next
            try:
                btx.commit_indexes()
                # user trigger log between index commit and the SECONDARY
                # WAL record (reference: StandardTitanGraph.commit:725-772)
                if tx.log_identifier:
                    from titan_tpu_torch.core.changes import (USER_LOG_PREFIX,
                                                        change_payload)
                    ulog = self.backend.log_manager.open_log(
                        USER_LOG_PREFIX + tx.log_identifier)
                    # without a WAL there is no txid; a commit timestamp is
                    # the next-best unique tag for the change stream
                    tag = txid if txid is not None \
                        else self.backend.times.time()
                    ulog.add(self.serializer.value_bytes(
                        change_payload(self, tx, tag)))
                if wal is not None:
                    wal.log_secondary_success(txid)
            except BaseException:
                if wal is not None:
                    wal.log_secondary_failure(txid)
                raise
        finally:
            # EVERY exit path releases locks — a leak would wedge this
            # column for every later tx until expiry
            if locker is not None and lock_state.has_locks:
                locker.release_locks(lock_state)

    # ------------------------------------------------- change subscription

    @property
    def mutation_epoch(self) -> int:
        """Monotone counter of committed transactions on THIS instance —
        the snapshot staleness epoch (snapshot.epoch < graph.mutation_epoch
        means the snapshot misses committed data)."""
        return self._mutation_epoch

    def subscribe_changes(self) -> tuple[int, "ChangeQueue"]:
        """Register an in-process change listener; every commit pushes its
        change payload (core/changes.change_payload shape + ``epoch``) to
        the returned queue. The registry holds it WEAKLY — keep a strong
        reference (snapshots do) or it auto-unregisters. Used by OLAP
        snapshots for delta refresh."""
        with self._commit_lock:
            return self._subscribe_locked()

    def _subscribe_locked(self) -> tuple[int, "ChangeQueue"]:
        """Register a listener; caller must hold ``_commit_lock`` (lets
        snapshot.build() atomically check the epoch and subscribe)."""
        from titan_tpu_torch.core.changes import ChangeQueue
        self._listener_seq += 1
        token = self._listener_seq
        q = ChangeQueue(cap=self.config.get(d.TPU_CHANGE_BACKLOG))
        self._change_listeners[token] = q
        return token, q

    def unsubscribe_changes(self, token: int) -> None:
        self._change_listeners.pop(token, None)

    def _needs_lock(self, rel) -> bool:
        if self.backend.locker is None:
            return False
        if self.schema.system.is_system(rel.type_id):
            return False
        st = self.schema.get_type(rel.type_id)
        return st is not None and getattr(st, "consistency", "none") == "lock"

    def _read_current_value(self, lid) -> Optional[bytes]:
        from titan_tpu_torch.storage.api import KeySliceQuery, SliceQuery
        from titan_tpu_torch.codec.relation_ids import next_prefix
        store = (self.backend.index_store.store if lid.store == "graphindex"
                 else self.backend.edge_store.store)
        txh = self.backend.manager.begin_transaction()
        try:
            entries = store.get_slice(
                KeySliceQuery(lid.key, SliceQuery(lid.column,
                                                  next_prefix(lid.column))), txh)
        finally:
            txh.commit()
        for e in entries:
            if e.column == lid.column:
                return e.value
        return None

    def _check_unique(self, unique_adds: list, idx_deletions: dict) -> None:
        """Uniqueness constraint: the composite row of a unique index must be
        empty (or already hold only this element) before the write — entries
        this same transaction deletes don't count, so a unique value can move
        between elements in one commit. (reference: unique composite indexes
        lock the index row and fail on a conflicting entry)"""
        if not unique_adds:
            return
        from titan_tpu_torch.storage.api import KeySliceQuery, SliceQuery
        from titan_tpu_torch.errors import SchemaViolationError
        by_row: dict[bytes, set] = {}
        for row_key, column in unique_adds:   # intra-tx duplicates
            by_row.setdefault(row_key, set()).add(column)
            if len(by_row[row_key]) > 1:
                raise SchemaViolationError(
                    "unique index constraint violated: two elements in this "
                    "transaction share the same indexed value")
        txh = self.backend.manager.begin_transaction()
        try:
            for row_key, column in unique_adds:
                dropped = set(idx_deletions.get(row_key, ()))
                entries = self.backend.index_store.store.get_slice(
                    KeySliceQuery(row_key, SliceQuery()), txh)
                for e in entries:
                    if e.column != column and e.column not in dropped:
                        raise SchemaViolationError(
                            "unique index constraint violated: value already "
                            "bound to another element")
        finally:
            txh.commit()

    def _route_row(self, row_vid: int, other_vid: int) -> int:
        """Physical row for one endpoint of an edge. A vertex cut's edge
        entry lands on the representative copy in the OTHER endpoint's
        partition, so the two rows of an edge colocate (reference:
        docs/partitioning.txt:33-47 — writes go to the copy colocated with
        the other endpoint; system relations stay on the canonical copy)."""
        if self.idm.is_partitioned_vertex(row_vid) and \
                not self.idm.is_schema_id(other_vid):
            return self.idm.partitioned_vertex_id(
                self.idm.count(row_vid), self.idm.partition(other_vid))
        return row_vid

    def _serialize(self, rel):
        """Yield (row_vertex_id, Entry) per materialized endpoint row.
        Relation endpoints inside the entry are always CANONICAL ids; only
        the row key is representative-routed."""
        if rel.is_property:
            yield rel.out_vertex_id, self.codec.write_property(
                rel.type_id, rel.relation_id, rel.value, self.schema,
                rel.properties)
            return
        # edge: OUT row always; IN row unless unidirected or endpoint is a
        # schema vertex (vertex-label edges only materialize on the OUT side)
        yield self._route_row(rel.out_vertex_id, rel.in_vertex_id), \
            self.codec.write_edge(
                rel.type_id, rel.relation_id, Direction.OUT, rel.in_vertex_id,
                self.schema, rel.properties)
        unidirected = False
        st = self.schema.get_type(rel.type_id) \
            if not self.schema.system.is_system(rel.type_id) else None
        if st is not None and getattr(st, "unidirected", False):
            unidirected = True
        if self.idm.is_schema_id(rel.in_vertex_id):
            unidirected = True
        if not unidirected:
            yield self._route_row(rel.in_vertex_id, rel.out_vertex_id), \
                self.codec.write_edge(
                    rel.type_id, rel.relation_id, Direction.IN,
                    rel.out_vertex_id, self.schema, rel.properties)

    # -- lifecycle -----------------------------------------------------------

    def _check_open(self):
        if not self._open:
            raise TitanError("graph is closed")

    @property
    def is_open(self) -> bool:
        return self._open

    def close(self) -> None:
        if not self._open:
            return
        self._open = False
        for r in getattr(self, "_reporters", ()):
            r.stop()
        try:
            self.backend.instance_registry.deregister(self.instance_id)
        except Exception:
            pass
        self.id_assigner.close()
        for provider in self._index_providers.values():
            try:
                provider.close()
            except Exception:
                pass
        self.backend.close()

    def clear(self) -> None:
        """Drop all data (test helper; reference: TitanCleanup)."""
        self.backend.clear_storage()
        for provider in self._index_providers.values():
            provider.clear_storage()
        self.schema.expire()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
