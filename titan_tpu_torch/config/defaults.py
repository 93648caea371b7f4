"""The root option tree.

Counterpart of the reference's GraphDatabaseConfiguration option declarations
(reference: titan-core graphdb/configuration/GraphDatabaseConfiguration.java:85-1275,
~200 options across the root/storage/cache/ids/index/cluster/log/metrics
namespaces). Backend-specific options are declared here too for the built-in
backends; external adapter modules may attach their own namespaces at import
time (the tree is a live registry, like the reference's
ReflectiveConfigOptionLoader auto-discovery).
"""

from __future__ import annotations

from titan_tpu_torch.config.options import (ConfigNamespace, ConfigOption, Mutability,
                                      non_negative, one_of, positive)

ROOT = ConfigNamespace(None, "root", "titan_tpu_torch root namespace")

# --- graph ------------------------------------------------------------------
GRAPH_NS = ConfigNamespace(ROOT, "graph", "general graph options")
UNIQUE_INSTANCE_ID = ConfigOption(
    GRAPH_NS, "unique-instance-id",
    "unique id of this graph instance within the cluster; auto-generated when unset",
    str, None, Mutability.LOCAL)
ALLOW_SETTING_VERTEX_ID = ConfigOption(
    GRAPH_NS, "set-vertex-id", "allow users to supply vertex ids",
    bool, False, Mutability.FIXED)
TIMESTAMP_PROVIDER = ConfigOption(
    GRAPH_NS, "timestamps", "clock resolution for backend timestamps",
    str, "micro", Mutability.FIXED, one_of("nano", "micro", "milli"))

# --- cluster ----------------------------------------------------------------
CLUSTER_NS = ConfigNamespace(ROOT, "cluster", "cluster-wide data layout")
MAX_PARTITIONS = ConfigOption(
    CLUSTER_NS, "max-partitions",
    "number of virtual partitions vertex ids are spread over; must be a power "
    "of 2; equals the maximum useful TPU shard count for the OLAP engine",
    int, 32, Mutability.FIXED, lambda v: v > 0 and (v & (v - 1)) == 0)
PARTITIONED_VERTICES = ConfigOption(
    CLUSTER_NS, "partition", "enable partitioned (vertex-cut) vertex labels",
    bool, False, Mutability.FIXED)

# --- storage ----------------------------------------------------------------
STORAGE_NS = ConfigNamespace(ROOT, "storage", "storage backend")
STORAGE_BACKEND = ConfigOption(
    STORAGE_NS, "backend",
    "storage backend shorthand or import path (shorthands: inmemory, sqlite)",
    str, None, Mutability.LOCAL)
STORAGE_DIRECTORY = ConfigOption(
    STORAGE_NS, "directory", "data directory for local backends",
    str, None, Mutability.LOCAL)
STORAGE_HOSTNAME = ConfigOption(
    STORAGE_NS, "hostname", "comma-separated backend hosts",
    list, [], Mutability.LOCAL)
STORAGE_PORT = ConfigOption(STORAGE_NS, "port", "backend port", int, None, Mutability.LOCAL)
STORAGE_READONLY = ConfigOption(STORAGE_NS, "read-only", "open read-only",
                                bool, False, Mutability.LOCAL)
STORAGE_BATCH = ConfigOption(
    STORAGE_NS, "batch-loading", "bulk-load mode: disables locking and "
    "consistency checks for ingest", bool, False, Mutability.LOCAL)
STORAGE_TRANSACTIONAL = ConfigOption(
    STORAGE_NS, "transactions", "use backend transactions when available",
    bool, True, Mutability.MASKABLE)
BUFFER_SIZE = ConfigOption(
    STORAGE_NS, "buffer-size", "mutations buffered per backend flush",
    int, 1024, Mutability.MASKABLE, positive)
WRITE_ATTEMPTS = ConfigOption(
    STORAGE_NS, "write-attempts", "max retries for backend writes",
    int, 5, Mutability.MASKABLE, positive)
READ_ATTEMPTS = ConfigOption(
    STORAGE_NS, "read-attempts", "max retries for backend reads",
    int, 3, Mutability.MASKABLE, positive)
STORAGE_ATTEMPT_WAIT_MS = ConfigOption(
    STORAGE_NS, "attempt-wait", "initial backoff between retries (ms)",
    int, 250, Mutability.MASKABLE, non_negative)
PARALLEL_BACKEND_OPS = ConfigOption(
    STORAGE_NS, "parallel-backend-ops", "execute multi-key slices on a host pool",
    bool, True, Mutability.MASKABLE)

CLUSTER_NS = ConfigNamespace(
    STORAGE_NS, "cluster", "remote-cluster backend (sharded + replicated "
    "storage nodes; reference role: the Cassandra/HBase cluster itself)")
CLUSTER_REPLICATION = ConfigOption(
    CLUSTER_NS, "replication-factor",
    "copies of each key across storage nodes", int, 1,
    Mutability.GLOBAL_OFFLINE, positive)
CLUSTER_WRITE_CONSISTENCY = ConfigOption(
    CLUSTER_NS, "write-consistency",
    "acks required per write: all | quorum | one", str, "all",
    Mutability.MASKABLE,
    lambda v: v in ("all", "quorum", "one"))
CLUSTER_VNODES = ConfigOption(
    CLUSTER_NS, "virtual-nodes", "hash-ring virtual nodes per storage node",
    int, 64, Mutability.GLOBAL_OFFLINE, positive)
CLUSTER_READ_REPAIR = ConfigOption(
    CLUSTER_NS, "read-repair",
    "chance per read of a full-replica merge + write-back of stale cells "
    "under write-consistency=all (quorum/one always merge-read)",
    float, 0.1, Mutability.MASKABLE, lambda v: 0.0 <= v <= 1.0)
CLUSTER_MAX_HINTS = ConfigOption(
    CLUSTER_NS, "max-hints-per-peer",
    "hinted-handoff queue cap per down peer; overflow converges via "
    "merged reads + the next anti-entropy pass", int, 50_000,
    Mutability.MASKABLE, positive)
CLUSTER_TIMEOUT = ConfigOption(
    CLUSTER_NS, "request-timeout-s",
    "socket timeout applied to EVERY storage-node RPC (reads, "
    "mutations, probes) on remote and remote-cluster backends", float,
    30.0, Mutability.MASKABLE, positive)
CLUSTER_COMPACTION_INTERVAL = ConfigOption(
    CLUSTER_NS, "compaction-interval-s",
    "period of the background anti-entropy + tombstone-GC daemon "
    "(0 disables; cycles are skipped while a replica is down or hints "
    "are undelivered — the Cassandra scheduled repair/compaction role)",
    float, 0.0, Mutability.MASKABLE, lambda v: v >= 0.0)
CLUSTER_GC_GRACE = ConfigOption(
    CLUSTER_NS, "gc-grace-seconds",
    "minimum tombstone age before the compaction daemon may purge it "
    "(Cassandra gc_grace_seconds role)", float, 86400.0,
    Mutability.MASKABLE, lambda v: v >= 0.0)

SCAN_NS = ConfigNamespace(STORAGE_NS, "scan", "backend scan framework")
SCAN_THREADS = ConfigOption(
    SCAN_NS, "threads", "processor threads per scan job", int, 4,
    Mutability.MASKABLE, positive)
SCAN_QUEUE_SIZE = ConfigOption(
    SCAN_NS, "queue-size", "bounded row-queue capacity between the data "
    "puller and the processors", int, 1024, Mutability.MASKABLE, positive)
SCAN_BLOCK_SIZE = ConfigOption(
    SCAN_NS, "block-size", "rows per processor progress block", int, 1000,
    Mutability.MASKABLE, positive)

LOCK_NS = ConfigNamespace(STORAGE_NS, "lock", "distributed locking")
LOCK_RETRIES = ConfigOption(LOCK_NS, "retries", "lock-claim write retries",
                            int, 3, Mutability.MASKABLE, positive)
LOCK_WAIT_MS = ConfigOption(
    LOCK_NS, "wait-time", "ms to wait for a lock claim to become visible; must "
    "exceed worst-case clock skew + write latency", int, 100,
    Mutability.GLOBAL_OFFLINE, positive)
LOCK_EXPIRY_MS = ConfigOption(
    LOCK_NS, "expiry-time", "ms after which an unreleased lock claim is stale",
    int, 300_000, Mutability.GLOBAL_OFFLINE, positive)
LOCK_CLEAN_EXPIRED = ConfigOption(
    LOCK_NS, "clean-expired", "background-delete expired lock claims",
    bool, False, Mutability.MASKABLE)
LOCK_LOCAL_MEDIATOR_GROUP = ConfigOption(
    LOCK_NS, "local-mediator-group",
    "processes sharing a mediator group arbitrate locks in-process first",
    str, None, Mutability.LOCAL)

# --- ids --------------------------------------------------------------------
IDS_NS = ConfigNamespace(ROOT, "ids", "id allocation")
IDS_BLOCK_SIZE = ConfigOption(
    IDS_NS, "block-size", "ids claimed per allocation block; raise for ingest",
    int, 10_000, Mutability.GLOBAL_OFFLINE, positive)
IDS_RENEW_TIMEOUT_MS = ConfigOption(
    IDS_NS, "renew-timeout", "ms to keep trying to claim an id block",
    int, 120_000, Mutability.MASKABLE, positive)
IDS_RENEW_PERCENTAGE = ConfigOption(
    IDS_NS, "renew-percentage", "fraction of the current block left when "
    "background renewal starts", float, 0.3, Mutability.MASKABLE,
    lambda v: 0.01 <= v <= 1.0)
IDS_PLACEMENT = ConfigOption(
    IDS_NS, "placement", "partition placement strategy (simple|property)",
    str, "simple", Mutability.MASKABLE)
IDS_FLUSH = ConfigOption(
    IDS_NS, "flush", "assign ids immediately on element creation instead of "
    "at commit", bool, True, Mutability.MASKABLE)
IDS_AUTHORITY_NS = ConfigNamespace(IDS_NS, "authority", "id authority protocol")
IDAUTH_WAIT_MS = ConfigOption(
    IDS_AUTHORITY_NS, "wait-time",
    "ms a claim must remain uncontested before an id block is owned",
    int, 300, Mutability.GLOBAL_OFFLINE, positive)
IDAUTH_CONFLICT_AVOIDANCE = ConfigOption(
    IDS_AUTHORITY_NS, "conflict-avoidance-mode",
    "NONE | GLOBAL_AUTO (randomized uniqueid per claim attempt)",
    str, "NONE", Mutability.GLOBAL_OFFLINE, one_of("NONE", "GLOBAL_AUTO"))

# --- cache ------------------------------------------------------------------
CACHE_NS = ConfigNamespace(ROOT, "cache", "database-level store cache")
DB_CACHE = ConfigOption(CACHE_NS, "db-cache", "enable the backend read cache",
                        bool, False, Mutability.MASKABLE)
DB_CACHE_SIZE = ConfigOption(
    CACHE_NS, "db-cache-size", "cache size: entries (>1) ",
    int, 200_000, Mutability.MASKABLE, positive)
DB_CACHE_TIME_MS = ConfigOption(
    CACHE_NS, "db-cache-time", "expiration ms for cached slices (0=never)",
    int, 10_000, Mutability.GLOBAL_OFFLINE, non_negative)
DB_CACHE_CLEAN_WAIT_MS = ConfigOption(
    CACHE_NS, "db-cache-clean-wait",
    "ms a dirty key stays blacklisted after invalidation",
    int, 50, Mutability.GLOBAL_OFFLINE, non_negative)
TX_CACHE_SIZE = ConfigOption(
    CACHE_NS, "tx-cache-size", "per-transaction vertex cache size",
    int, 20_000, Mutability.MASKABLE, positive)
TX_DIRTY_SIZE = ConfigOption(
    CACHE_NS, "tx-dirty-size", "initial sizing for per-tx dirty sets",
    int, 32, Mutability.MASKABLE, positive)

# --- index (umbrella: index.<name>.*) ---------------------------------------
INDEX_NS = ConfigNamespace(ROOT, "index", "mixed index providers", umbrella=True)
INDEX_BACKEND = ConfigOption(
    INDEX_NS, "backend", "index backend shorthand or import path "
    "(shorthands: memindex)", str, "memindex", Mutability.GLOBAL_OFFLINE)
INDEX_DIRECTORY = ConfigOption(INDEX_NS, "directory", "index data directory",
                               str, None, Mutability.MASKABLE)
INDEX_HOSTNAME = ConfigOption(INDEX_NS, "hostname", "index hosts", list, [],
                              Mutability.MASKABLE)
INDEX_PORT = ConfigOption(INDEX_NS, "port", "index node port", int, None,
                          Mutability.MASKABLE)
INDEX_MAX_RESULT_SET = ConfigOption(
    INDEX_NS, "max-result-set-size", "cap on index result sets", int, 100_000,
    Mutability.MASKABLE, positive)

# --- log (umbrella: log.<name>.*) -------------------------------------------
LOG_NS = ConfigNamespace(ROOT, "log", "KCVS log bus (TitanBus analog)", umbrella=True)
LOG_BACKEND = ConfigOption(LOG_NS, "backend", "log implementation", str,
                           "default", Mutability.GLOBAL_OFFLINE)
LOG_NUM_BUCKETS = ConfigOption(
    LOG_NS, "num-buckets", "write parallelism buckets per partition", int, 1,
    Mutability.GLOBAL_OFFLINE, positive)
LOG_SEND_DELAY_MS = ConfigOption(
    LOG_NS, "send-delay", "ms messages may linger in the outgoing buffer",
    int, 1000, Mutability.MASKABLE, non_negative)
LOG_SEND_BATCH = ConfigOption(
    LOG_NS, "send-batch-size", "max messages per outgoing batch", int, 256,
    Mutability.MASKABLE, positive)
LOG_READ_INTERVAL_MS = ConfigOption(
    LOG_NS, "read-interval", "poll interval for log readers (ms)", int, 500,
    Mutability.MASKABLE, positive)
LOG_READ_BATCH = ConfigOption(
    LOG_NS, "read-batch-size", "max messages per read poll", int, 1024,
    Mutability.MASKABLE, positive)
LOG_TTL_S = ConfigOption(
    LOG_NS, "ttl", "seconds log entries are retained (0 = forever)", int, 0,
    Mutability.GLOBAL, non_negative)

# --- tx ---------------------------------------------------------------------
TX_NS = ConfigNamespace(ROOT, "tx", "transaction handling")
LOG_TX = ConfigOption(
    TX_NS, "log-tx", "write a WAL record for every transaction into the "
    "tx log for recovery", bool, False, Mutability.GLOBAL)
TX_LOG_NAME = ConfigOption(TX_NS, "log-name", "name of the WAL log", str,
                           "txlog", Mutability.GLOBAL_OFFLINE)
TX_RECOVERY_INTERVAL_MS = ConfigOption(
    TX_NS, "recovery-interval", "how far behind the recovery reader starts",
    int, 10_000, Mutability.MASKABLE, positive)

# --- query ------------------------------------------------------------------
QUERY_NS = ConfigNamespace(ROOT, "query", "query execution")
FORCE_INDEX = ConfigOption(
    QUERY_NS, "force-index", "refuse graph queries that would full-scan",
    bool, False, Mutability.MASKABLE)
QUERY_BATCH = ConfigOption(
    QUERY_NS, "batch", "batch multi-vertex backend retrievals", bool, True,
    Mutability.MASKABLE)
SMART_LIMIT = ConfigOption(
    QUERY_NS, "smart-limit", "guess small limits for interactive queries",
    bool, True, Mutability.MASKABLE)
FAST_PROPERTY = ConfigOption(
    QUERY_NS, "fast-property",
    "prefetch all properties on first single-property access",
    bool, True, Mutability.MASKABLE)
TRAVERSAL_BATCH = ConfigOption(
    QUERY_NS, "traversal-batch",
    "vertices per batched multi-vertex adjacency fetch in the traversal "
    "engine (the multiQuery batch width)", int, 512,
    Mutability.MASKABLE, positive)
BARRIER_SIZE = ConfigOption(
    QUERY_NS, "barrier-size",
    "bulking-barrier chunk — TP3 LazyBarrierStrategy's max barrier size "
    "(bounds how much laziness a barrier may consume)", int, 2500,
    Mutability.MASKABLE, positive)

# --- metrics ----------------------------------------------------------------
METRICS_NS = ConfigNamespace(ROOT, "metrics", "metrics collection")
BASIC_METRICS = ConfigOption(METRICS_NS, "enabled", "collect per-op metrics",
                             bool, False, Mutability.MASKABLE)
METRICS_PREFIX = ConfigOption(METRICS_NS, "prefix", "metric name prefix", str,
                              "titan_tpu", Mutability.MASKABLE)
# periodic background reporters (reference: per-reporter config
# namespaces metrics.console/csv/ganglia/graphite with intervals,
# GraphDatabaseConfiguration.java:1010-1226); interval 0 = reporter off
METRICS_CONSOLE_NS = ConfigNamespace(METRICS_NS, "console",
                                     "console metrics reporter")
METRICS_CONSOLE_INTERVAL = ConfigOption(
    METRICS_CONSOLE_NS, "interval-s",
    "seconds between console metric reports (0 = off)", float, 0.0,
    Mutability.MASKABLE, non_negative)
METRICS_CSV_NS = ConfigNamespace(METRICS_NS, "csv",
                                 "CSV metrics reporter")
METRICS_CSV_INTERVAL = ConfigOption(
    METRICS_CSV_NS, "interval-s",
    "seconds between CSV metric snapshots (0 = off)", float, 0.0,
    Mutability.MASKABLE, non_negative)
METRICS_CSV_DIR = ConfigOption(
    METRICS_CSV_NS, "directory",
    "directory for timestamped CSV metric snapshots", str, "metrics-csv",
    Mutability.MASKABLE)
METRICS_GRAPHITE_NS = ConfigNamespace(METRICS_NS, "graphite",
                                      "Graphite/Carbon metrics reporter")
METRICS_GRAPHITE_INTERVAL = ConfigOption(
    METRICS_GRAPHITE_NS, "interval-s",
    "seconds between Graphite pushes (0 = off)", float, 0.0,
    Mutability.MASKABLE, non_negative)
METRICS_GRAPHITE_HOST = ConfigOption(
    METRICS_GRAPHITE_NS, "host", "Graphite/Carbon plaintext host", str,
    "localhost", Mutability.MASKABLE)
METRICS_GRAPHITE_PORT = ConfigOption(
    METRICS_GRAPHITE_NS, "port", "Graphite/Carbon plaintext port", int,
    2003, Mutability.MASKABLE, positive)

# --- computer / TPU OLAP -----------------------------------------------------
COMPUTER_NS = ConfigNamespace(ROOT, "computer", "OLAP graph computer")
COMPUTER_BACKEND = ConfigOption(
    COMPUTER_NS, "backend", "graph computer: gpu (the superstep engine on "
    "one card) or host (thread-pool host executor); tpu is not ported", str, "gpu",
    Mutability.MASKABLE, one_of("host", "tpu", "gpu"))
COMPUTER_THREADS = ConfigOption(
    COMPUTER_NS, "threads", "host computer worker threads (0 = n_cpus)", int,
    0, Mutability.MASKABLE, non_negative)
TPU_NS = ConfigNamespace(COMPUTER_NS, "tpu", "TPU engine tuning")
TPU_MESH_SHAPE = ConfigOption(
    TPU_NS, "mesh", "device mesh size over the vertex axis (0 = all devices)",
    int, 0, Mutability.MASKABLE, non_negative)
TPU_EDGE_BLOCK = ConfigOption(
    TPU_NS, "edge-block-size", "edges per scan block when building snapshots",
    int, 1 << 20, Mutability.MASKABLE, positive)
TPU_DTYPE = ConfigOption(
    TPU_NS, "value-dtype", "dtype for dense vertex state (bfloat16|float32)",
    str, "float32", Mutability.MASKABLE, one_of("bfloat16", "float32"))
TPU_CHANGE_BACKLOG = ConfigOption(
    TPU_NS, "change-backlog",
    "commits a snapshot's delta listener may buffer before declaring "
    "overflow (a rebuild is then required instead of refresh())", int,
    10_000, Mutability.MASKABLE, positive)
# keep config a LEAF module: core.changes keeps its own copy of this
# default; the pairing is pinned by
# tests/test_torch_store.py::test_change_queue_overflows_at_its_cap
