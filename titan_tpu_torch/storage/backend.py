"""Backend orchestrator: opens and wires the named stores of a graph (the
port's copy of ``titan_tpu/storage/backend.py``; ``metrics.enabled``
wraps the raw store manager in ``utils/metrics``'s instrumented manager,
below the store cache).

(reference: titan-core diskstorage/Backend.java:66-711 — fixed store names
:78-90, cache wrapping :256-265, id-authority store :225-231, global config
over system_properties :273-298, scanner :194. The reference's four stores
carry over: ``edgestore`` (adjacency), ``graphindex`` (composite indexes +
system name index), ``system_ids`` (id-authority claims), and
``system_properties`` (cluster-global config); log stores are opened on
demand by the log manager.)
"""

from __future__ import annotations

from typing import Optional

from titan_tpu_torch.storage.api import KeyColumnValueStoreManager
from titan_tpu_torch.storage.cache import ExpirationStoreCache, NoCache, StoreCache
from titan_tpu_torch.storage.config_store import InstanceRegistry, KCVSConfiguration
from titan_tpu_torch.storage.locking import ConsistentKeyLocker, LocalLockMediator
from titan_tpu_torch.storage.log import LogManager
from titan_tpu_torch.storage.registry import store_manager
from titan_tpu_torch.storage.tx import BackendTransaction
from titan_tpu_torch.ids.authority import ConsistentKeyIDAuthority, IDAuthority
from titan_tpu_torch.utils.times import TimestampProvider, provider as time_provider

EDGESTORE_NAME = "edgestore"
INDEXSTORE_NAME = "graphindex"
ID_STORE_NAME = "system_ids"
CONFIG_STORE_NAME = "system_properties"
LOCK_STORE_NAME = "system_locks"
LOG_STORE_NAME = "systemlog_store"


class Backend:
    def __init__(self, config=None, manager: Optional[KeyColumnValueStoreManager] = None,
                 instance_id: str = "i0"):
        from titan_tpu_torch.config import defaults as d
        self.config = config
        if manager is None:
            if config is None:
                raise ValueError("need a config or an explicit store manager")
            backend_name = config.get(d.STORAGE_BACKEND)
            if not backend_name:
                raise ValueError("storage.backend is not set")
            manager = store_manager(
                backend_name,
                directory=config.get(d.STORAGE_DIRECTORY),
                read_only=config.get(d.STORAGE_READONLY),
                hostname=config.get(d.STORAGE_HOSTNAME),
                port=config.get(d.STORAGE_PORT),
                replication=config.get(d.CLUSTER_REPLICATION),
                write_consistency=config.get(d.CLUSTER_WRITE_CONSISTENCY),
                virtual_nodes=config.get(d.CLUSTER_VNODES),
                read_repair=config.get(d.CLUSTER_READ_REPAIR),
                max_hints_per_peer=config.get(d.CLUSTER_MAX_HINTS),
                timeout=config.get(d.CLUSTER_TIMEOUT))
            interval = config.get(d.CLUSTER_COMPACTION_INTERVAL)
            if interval > 0 and hasattr(manager, "start_auto_compaction"):
                manager.start_auto_compaction(
                    interval, config.get(d.CLUSTER_GC_GRACE))
        # metrics wrapping sits directly over the raw manager so every opened
        # store is instrumented, and the expiration cache layers ABOVE it —
        # cache hits don't count as backend ops (reference: Backend.java:142-146)
        if config is not None and config.get(d.BASIC_METRICS):
            from titan_tpu_torch.utils.metrics import \
                MetricInstrumentedStoreManager
            manager = MetricInstrumentedStoreManager(
                manager, prefix=config.get(d.METRICS_PREFIX) or "titan_tpu")
        self.manager = manager
        self.instance_id = instance_id

        cache_enabled = bool(config and config.get(d.DB_CACHE))
        cache_args = {}
        if config is not None:
            cache_args = dict(max_entries=config.get(d.DB_CACHE_SIZE),
                              expire_ms=config.get(d.DB_CACHE_TIME_MS),
                              clean_wait_ms=config.get(d.DB_CACHE_CLEAN_WAIT_MS))

        def wrap(store):
            if cache_enabled:
                return ExpirationStoreCache(store, **cache_args)
            return NoCache(store)

        self.edge_store: StoreCache = wrap(manager.open_database(EDGESTORE_NAME))
        self.index_store: StoreCache = wrap(manager.open_database(INDEXSTORE_NAME))
        self.id_store = manager.open_database(ID_STORE_NAME)
        self.config_store = manager.open_database(CONFIG_STORE_NAME)

        self.times: TimestampProvider = time_provider(
            config.get(d.TIMESTAMP_PROVIDER) if config else "micro")
        wait_ms = config.get(d.IDAUTH_WAIT_MS) if config else 50
        self.id_authority: IDAuthority = ConsistentKeyIDAuthority(
            self.id_store, manager, instance_id.encode("utf-8"), self.times,
            wait_ms=wait_ms)

        self._buffer_size = config.get(d.BUFFER_SIZE) if config else 1024
        self._read_attempts = config.get(d.READ_ATTEMPTS) if config else 3
        self._write_attempts = config.get(d.WRITE_ATTEMPTS) if config else 5
        self._wait_ms = config.get(d.STORAGE_ATTEMPT_WAIT_MS) if config else 250

        # cluster-global config + instance registry (reference:
        # KCVSConfiguration over system_properties, Backend.java:273-298)
        from titan_tpu_torch.codec.attributes import Serializer as _Ser
        self.global_config_store = KCVSConfiguration(
            self.config_store, manager, _Ser())
        self.instance_registry = InstanceRegistry(self.config_store, manager)

        # consistent-key locking (skipped when the store has native locking
        # or batch-loading is on; reference: Backend.java:166-171)
        rid = instance_id.encode("utf-8")
        batch = bool(config and config.get(d.STORAGE_BATCH))
        if not manager.features.locking and not batch:
            group = (config.get(d.LOCK_LOCAL_MEDIATOR_GROUP)
                     if config else None) or f"{id(manager)}"
            self.locker = ConsistentKeyLocker(
                manager.open_database(LOCK_STORE_NAME), manager, rid,
                self.times,
                wait_ms=config.get(d.LOCK_WAIT_MS) if config else 100,
                expiry_ms=config.get(d.LOCK_EXPIRY_MS) if config else 300_000,
                retries=config.get(d.LOCK_RETRIES) if config else 3,
                mediator=LocalLockMediator.instance(group))
        else:
            self.locker = None

        # log bus (WAL, schema broadcasts, user trigger logs)
        self.log_manager = LogManager(manager, LOG_STORE_NAME, rid, self.times)
        self._closed = False

    @property
    def features(self):
        return self.manager.features

    def set_timestamp_provider(self, name: str) -> None:
        """Re-align every timestamp consumer after the cluster-global (FIXED)
        provider is known — lock-claim and log ordering must agree across
        instances, so the global value overrides the local guess."""
        times = time_provider(name)
        if type(times) is type(self.times):
            return
        self.times = times
        if isinstance(self.id_authority, ConsistentKeyIDAuthority):
            self.id_authority._times = times
        if self.locker is not None:
            self.locker._times = times
        self.log_manager._times = times

    def begin_transaction(self, tx_config=None,
                          index_txs: Optional[dict] = None) -> BackendTransaction:
        store_tx = self.manager.begin_transaction(tx_config)
        return BackendTransaction(
            store_tx, self.manager, self.edge_store, self.index_store,
            buffer_size=self._buffer_size, attempts=self._read_attempts,
            wait_ms=self._wait_ms, write_attempts=self._write_attempts,
            index_txs=index_txs)

    def clear_storage(self) -> None:
        self.manager.clear_storage()
        self.edge_store.clear()
        self.index_store.clear()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.log_manager.close()
        self.id_authority.close()
        self.manager.close()
