"""Sharded + replicated storage over multiple remote KCVS nodes.

``storage.backend=remote-cluster`` with ``storage.hostname`` listing N
storage nodes (``host`` or ``host:port`` entries — each an ordinary
``python -m titan_tpu_torch.storage.remote`` node). Plays the role the reference
delegates to the Cassandra/HBase CLUSTER itself (reference:
titan-cassandra AbstractCassandraStoreManager — partitioner-driven key
placement, per-key replication, consistency levels at
CassandraTransaction/CLevel; Titan layers locking and the id-authority
claim protocol on top and treats the store as eventually consistent):

* **Placement**: consistent-hash ring with virtual nodes (the
  Murmur3Partitioner shape). Each key lives on its ``replication-factor``
  distinct successor nodes.
* **Cells**: every stored value is a timestamped cell
  ``[magic:1][ts:8][flag:1][expiry:8][payload]`` and deletions are
  written as TOMBSTONE cells, so replicas can always merge
  last-writer-wins (the Cassandra cell model). TTL'd writes carry their
  absolute expiry so read repair re-derives the remaining TTL instead of
  resurrecting expired cells. Reads unwrap; tombstoned/expired columns
  are invisible.
* **Writes**: sent to every replica; ``storage.cluster.write-consistency``
  = ``all`` | ``quorum`` | ``one`` decides how many acks a mutation needs.
  Mutations for replicas that are down are queued as **hints** and
  replayed when the peer comes back (hinted handoff); LWW cells make the
  replay safe in any order.
* **Reads**: with ``write-consistency=all`` a single alive replica is
  authoritative (fast path), and divergence is repaired probabilistically
  (``storage.cluster.read-repair`` chance per read). With ``quorum``/
  ``one`` every read merges all alive replicas LWW and writes winning
  cells back to stale replicas (**read repair**) — quorum writes + merged
  reads preserve read-your-writes, so ``features.key_consistent`` holds
  for ``all`` and ``quorum``; with ``one`` (rf>1) it is honestly False
  and the locking/id-claim layers must not be pointed at it.
* **Scans**: ordered scans k-way-merge the per-node ordered streams and
  LWW-merge runs of the same key; unordered scans visit each node once
  and yield a key only from its first ALIVE replica (per-replica best
  effort, like the reference's eventually-consistent bulk scans).

Known limits (documented): tombstones persist until an operator runs
``compact_tombstones`` (a full anti-entropy sync + gc_grace purge; it
requires every replica up so a purged tombstone cannot un-suppress a
stale cell); a column-limited slice can return fewer than ``limit`` live
columns when a tombstone superseded a fetched column (the classic
Cassandra short-read); hint queues are bounded — after an overflow the
peer is tainted and ALL reads merge replicas until the next full sync
clears it.
"""

from __future__ import annotations

import hashlib
import heapq
import random
import struct
import threading
import time
from typing import Iterator, Optional, Sequence

from titan_tpu_torch.errors import TemporaryBackendError
from titan_tpu_torch.storage.api import (Entry, EntryList, KCVMutation,
                                         KeyColumnValueStore,
                                         KeyColumnValueStoreManager,
                                         KeyRangeQuery, KeySliceQuery,
                                         SliceQuery, StoreFeatures,
                                         StoreTransaction, TTLEntry, entry_ttl)
from titan_tpu_torch.storage.remote import RemoteStoreManager

_LIVE = 0
_TOMB = 1
_MAGIC = 0xCE
# cell = [magic:1][ts:8][flag:1][expiry:8 double epoch s, 0 = no TTL][payload]
_HDR = struct.Struct(">BQBd")
MAX_HINTS_PER_PEER = 50_000


def _token(data: bytes) -> int:
    return int.from_bytes(hashlib.md5(data).digest()[:8], "big")


def _wrap(ts: int, payload: bytes, tomb: bool = False,
          expiry: float = 0.0) -> bytes:
    return _HDR.pack(_MAGIC, ts, _TOMB if tomb else _LIVE, expiry) + payload


def _unwrap(value: bytes) -> tuple[int, bool, bytes, float]:
    """(ts, is_tombstone, payload, expiry). Values not carrying the cell
    magic are treated as legacy live cells with ts 0 (they lose every
    merge). NOTE: a store written by a pre-cell-format build whose raw
    values happen to start with the magic byte would be misparsed — data
    written through any earlier remote-cluster build is NOT supported
    behind this backend (reload it), which is why the magic exists: it
    protects the common case, not arbitrary bytes."""
    if len(value) < _HDR.size or value[0] != _MAGIC:
        return 0, False, value, 0.0
    _, ts, flag, expiry = _HDR.unpack_from(value)
    return ts, flag == _TOMB, value[_HDR.size:], expiry


class HashRing:
    """Consistent-hash ring with virtual nodes; replicas(key) returns the
    first ``rf`` DISTINCT peers clockwise from the key's token."""

    def __init__(self, num_peers: int, rf: int, vnodes: int,
                 peer_ids: Sequence[str]):
        self.rf = min(rf, num_peers)
        points = []
        for p in range(num_peers):
            for v in range(vnodes):
                points.append((_token(f"{peer_ids[p]}#{v}".encode()), p))
        points.sort()
        self._tokens = [t for t, _ in points]
        self._owners = [p for _, p in points]
        # precomputed distinct-successor lists per ring position
        self._succ: list[tuple[int, ...]] = []
        m = len(points)
        for i in range(m):
            seen: list[int] = []
            j = i
            while len(seen) < self.rf and len(seen) < num_peers:
                p = self._owners[j % m]
                if p not in seen:
                    seen.append(p)
                j += 1
            self._succ.append(tuple(seen))

    def replicas(self, key: bytes) -> tuple[int, ...]:
        t = _token(key)
        import bisect
        i = bisect.bisect_right(self._tokens, t) % len(self._tokens)
        return self._succ[i]


def _merge_cells(rows: Sequence[tuple[int, EntryList]]
                 ) -> tuple[dict, dict]:
    """LWW-merge replica rows. ``rows``: [(peer, entries-with-wrapped-
    values)]. Returns (winners: {column: (ts, tomb, payload, wrapped,
    expiry)}, repairs: {peer: [wire entry with the winning cell]}).
    Repair entries preserve TTL: cells carry their absolute expiry, so
    the write-back re-derives the remaining TTL (an expired cell is
    never repaired back to life)."""
    now = time.time()
    winners: dict[bytes, tuple[int, bool, bytes, bytes, float]] = {}
    have: dict[int, dict[bytes, int]] = {}
    for p, entries in rows:
        mine = have.setdefault(p, {})
        for e in entries:
            ts, tomb, payload, expiry = _unwrap(e.value)
            mine[e.column] = ts
            cur = winners.get(e.column)
            # ties break on the raw cell bytes for cross-replica determinism
            if cur is None or (ts, e.value) > (cur[0], cur[3]):
                winners[e.column] = (ts, tomb, payload, e.value, expiry)
    repairs: dict[int, list] = {}
    for p, mine in have.items():
        stale = []
        for col, w in winners.items():
            if mine.get(col, -1) >= w[0]:
                continue
            if w[4]:                       # TTL'd cell
                remaining = w[4] - now
                if remaining <= 0:
                    continue               # expired: let it die everywhere
                stale.append(TTLEntry(col, w[3], remaining))
            else:
                stale.append(Entry(col, w[3]))
        if stale:
            repairs[p] = stale
    return winners, repairs


def _live_entries(winners: dict, limit: Optional[int]) -> EntryList:
    now = time.time()
    out = [Entry(col, w[2]) for col, w in sorted(winners.items())
           if not w[1] and (not w[4] or w[4] > now)]
    if limit is not None:
        out = out[:limit]
    return out


class ClusterStore(KeyColumnValueStore):
    def __init__(self, manager: "ClusterStoreManager", name: str):
        self._m = manager
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def _peer_store(self, p: int):
        return self._m.peer(p).open_database(self._name)

    # -- reads ---------------------------------------------------------------

    def _read_replicas(self, query: KeySliceQuery, txh,
                       skip: frozenset = frozenset()
                       ) -> list[tuple[int, EntryList]]:
        rows = []
        for p in self._m.ring.replicas(query.key):
            if p in skip:
                continue
            try:
                rows.append((p, self._peer_store(p).get_slice(query, txh)))
            except TemporaryBackendError:
                self._m.mark_down(p)
        return rows

    def get_slice(self, query: KeySliceQuery, txh,
                  skip: frozenset = frozenset()) -> EntryList:
        m = self._m
        if m.ring.rf == 1 or (m.wc == "all" and not m.repair_roll()):
            # fast path: any alive replica is authoritative under wc=all
            last: Optional[Exception] = None
            for p in m.ring.replicas(query.key):
                if p in skip:
                    continue
                try:
                    entries = self._peer_store(p).get_slice(query, txh)
                    return self._unwrap_list(entries, query.slice.limit)
                except TemporaryBackendError as e:
                    last = e
                    m.mark_down(p)
            raise TemporaryBackendError(
                f"no replica answered for key slice ({last})")
        rows = self._read_replicas(query, txh, skip)
        if not rows:
            raise TemporaryBackendError("no replica answered for key slice")
        if m.wc == "quorum" and len(rows) < m.required_acks():
            raise TemporaryBackendError(
                f"quorum read got {len(rows)}/{m.required_acks()} replicas")
        winners, repairs = _merge_cells(rows)
        self._apply_repairs({None: repairs}, {None: query.key}, txh)
        return _live_entries(winners, query.slice.limit)

    @staticmethod
    def _unwrap_list(entries: EntryList, limit: Optional[int]) -> EntryList:
        now = time.time()
        out = []
        for e in entries:
            _, tomb, payload, expiry = _unwrap(e.value)
            if not tomb and (not expiry or expiry > now):
                out.append(Entry(e.column, payload))
                if limit is not None and len(out) >= limit:
                    break
        return out

    def _apply_repairs(self, repairs_by_tag: dict, key_by_tag: dict,
                       txh) -> None:
        """Write winning cells back to stale replicas (read repair),
        batched per peer. Repair failures are non-fatal (the read already
        has a correct answer)."""
        per_peer: dict[int, dict[bytes, KCVMutation]] = {}
        for tag, repairs in repairs_by_tag.items():
            key = key_by_tag[tag]
            for p, entries in repairs.items():
                per_peer.setdefault(p, {})[key] = KCVMutation(entries, [])
        for p, by_key in per_peer.items():
            try:
                self._m.peer(p).mutate_many({self._name: by_key}, txh)
            except TemporaryBackendError:
                self._m.mark_down(p)

    def get_slice_multi(self, keys: Sequence[bytes], slice_query: SliceQuery,
                        txh) -> dict:
        m = self._m
        if m.ring.rf == 1 or (m.wc == "all" and not m.repair_roll()):
            # batch per first-choice replica, failing over per-group
            groups: dict[int, list[bytes]] = {}
            for k in keys:
                groups.setdefault(m.ring.replicas(k)[0], []).append(k)
            out: dict[bytes, EntryList] = {}
            for p, ks in groups.items():
                try:
                    got = self._peer_store(p).get_slice_multi(ks,
                                                              slice_query,
                                                              txh)
                    out.update({k: self._unwrap_list(v, slice_query.limit)
                                for k, v in got.items()})
                except TemporaryBackendError:
                    m.mark_down(p)
                    # per-key failover, never re-dialing the peer that just
                    # failed (each retry to a dead node costs a full
                    # connect timeout)
                    for k in ks:
                        out[k] = self.get_slice(
                            KeySliceQuery(k, slice_query), txh,
                            skip=frozenset((p,)))
            return out
        # merged read: batch each alive peer's share of the keys, then
        # LWW-merge per key and repair stale replicas in one batch per peer
        per_peer: dict[int, list[bytes]] = {}
        for k in keys:
            for p in m.ring.replicas(k):
                per_peer.setdefault(p, []).append(k)
        got_by_peer: dict[int, dict] = {}
        for p, ks in per_peer.items():
            try:
                got_by_peer[p] = self._peer_store(p).get_slice_multi(
                    ks, slice_query, txh)
            except TemporaryBackendError:
                m.mark_down(p)
        out = {}
        repairs_by_key: dict[bytes, dict] = {}
        for k in keys:
            rows = [(p, got_by_peer[p].get(k, []))
                    for p in m.ring.replicas(k) if p in got_by_peer]
            if not rows:
                raise TemporaryBackendError(
                    f"no replica answered for key {k!r}")
            if m.wc == "quorum" and len(rows) < m.required_acks():
                raise TemporaryBackendError(
                    f"quorum read got {len(rows)}/{m.required_acks()} "
                    f"replicas for key {k!r}")
            winners, repairs = _merge_cells(rows)
            out[k] = _live_entries(winners, slice_query.limit)
            if repairs:
                repairs_by_key[k] = repairs
        if repairs_by_key:
            self._apply_repairs(repairs_by_key,
                                {k: k for k in repairs_by_key}, txh)
        return out

    # -- writes --------------------------------------------------------------

    def mutate(self, key: bytes, additions: Sequence[Entry],
               deletions: Sequence[bytes], txh) -> None:
        self._m.mutate_many(
            {self._name: {key: KCVMutation(list(additions),
                                           list(deletions))}}, txh)

    # -- scans ---------------------------------------------------------------

    def get_keys(self, query, txh) -> Iterator:
        if isinstance(query, KeyRangeQuery):
            return self._ordered_scan(query, txh)
        return self._unordered_scan(query, txh)

    def _ordered_scan(self, query: KeyRangeQuery, txh) -> Iterator:
        """Globally ordered iteration: k-way merge of each node's ordered
        stream; runs of the same key from different replicas are
        LWW-merged (so a stale replica can't resurrect deleted columns).
        Peers are probed up front (get_keys is a lazy generator — a dead
        node would otherwise only surface mid-merge); a node dying
        MID-scan raises TemporaryBackendError for the caller's retry
        loop."""
        alive = self._m.probe_all()
        self._m.require_scan_coverage(alive)
        iters = []
        for p in alive:
            sub = KeyRangeQuery(query.key_start, query.key_end, query.slice,
                                None)
            it = self._peer_store(p).get_keys(sub, txh)
            iters.append(((k, p, entries) for k, entries in it))

        merged = heapq.merge(*iters, key=lambda kv: kv[0])
        yielded = 0
        run_key = None
        run: list[tuple[int, EntryList]] = []

        def flush():
            winners, _ = _merge_cells(run)
            return _live_entries(winners, query.slice.limit)

        for k, p, entries in merged:
            if k != run_key and run:
                live = flush()
                run = []
                if live:
                    yield run_key, live
                    yielded += 1
                    if query.key_limit is not None \
                            and yielded >= query.key_limit:
                        return
            run_key = k
            run.append((p, entries))
        if run:
            live = flush()
            if live:
                yield run_key, live

    def _unordered_scan(self, query: SliceQuery, txh) -> Iterator:
        alive = self._m.probe_all()
        self._m.require_scan_coverage(alive)
        alive_set = set(alive)
        for p in alive:
            for k, entries in self._peer_store(p).get_keys(query, txh):
                owners = self._m.ring.replicas(k)
                first_alive = next((o for o in owners if o in alive_set),
                                   None)
                if first_alive == p:
                    live = self._unwrap_list(entries, query.limit)
                    if live:
                        yield k, live


class ClusterStoreManager(KeyColumnValueStoreManager):
    """``storage.backend=remote-cluster``."""

    def __init__(self, hosts: Sequence[str], port: int = 8283,
                 replication: int = 1, write_consistency: str = "all",
                 virtual_nodes: int = 64, timeout: float = 30.0,
                 read_repair: float = 0.1,
                 max_hints_per_peer: int = MAX_HINTS_PER_PEER):
        self._max_hints = max_hints_per_peer
        if not hosts:
            raise ValueError("remote-cluster needs storage.hostname entries")
        self._peer_ids = []
        self._peers: list[Optional[RemoteStoreManager]] = []
        self._addrs = []
        for h in hosts:
            host, _, p = h.partition(":")
            addr = (host or "127.0.0.1", int(p) if p else int(port or 8283))
            self._addrs.append(addr)
            self._peer_ids.append(f"{addr[0]}:{addr[1]}")
            self._peers.append(None)
        self._timeout = timeout
        self._down: set[int] = set()
        if write_consistency not in ("all", "quorum", "one"):
            raise ValueError(
                f"unknown write-consistency {write_consistency!r}")
        self.wc = write_consistency
        self._read_repair = float(read_repair)
        self._rng = random.Random(0xA57B)
        self._ts_lock = threading.Lock()
        self._last_ts = 0
        self._features_lock = threading.Lock()
        self._hints: dict[int, list[tuple[str, bytes, KCVMutation]]] = {}
        self._hints_lock = threading.Lock()
        # peers whose hint queue EVER overflowed: dropped hints may
        # include tombstones, so tombstone compaction is unsafe until a
        # full anti-entropy pass has run (compact_tombstones performs
        # one); reconnect alone must NOT clear this
        self._ever_overflowed: set[int] = set()
        self.ring = HashRing(len(self._addrs), max(1, int(replication)),
                             int(virtual_nodes), self._peer_ids)
        self._stores: dict[str, ClusterStore] = {}
        # background anti-entropy + tombstone GC (start_auto_compaction)
        self._compactor: Optional[threading.Thread] = None
        self._compactor_stop: Optional[threading.Event] = None
        self.compaction_stats = {"runs": 0, "purged": 0, "skipped": 0,
                                 "last_error": None}
        # reach at least one node up front (features: TTL = AND over
        # reachable peers, lazily refined as others connect)
        self._cell_ttl = True
        ok = False
        for p in range(self.num_peers):
            try:
                self.peer(p)
                ok = True
            except TemporaryBackendError:
                self.mark_down(p)
        if not ok:
            raise TemporaryBackendError(
                f"no cluster node reachable: {self._peer_ids}")

    # -- cells ---------------------------------------------------------------

    def next_ts(self) -> int:
        """Monotonic cell timestamp (ns since epoch, Lamport-bumped)."""
        with self._ts_lock:
            ts = max(time.time_ns(), self._last_ts + 1)
            self._last_ts = ts
            return ts

    def repair_roll(self) -> bool:
        # a peer whose hint queue EVER overflowed holds unknown staleness
        # until a full anti-entropy pass (compact_tombstones) heals it —
        # reconnect alone replays only the queued, non-spilled hints — so
        # merged reads stay forced for the whole window
        if self._ever_overflowed:
            return True
        return self._read_repair > 0 and \
            self._rng.random() < self._read_repair

    # -- peers ---------------------------------------------------------------

    @property
    def num_peers(self) -> int:
        return len(self._addrs)

    def peer(self, p: int) -> RemoteStoreManager:
        mgr = self._peers[p]
        if mgr is None:
            host, port = self._addrs[p]
            try:
                mgr = RemoteStoreManager(host, port, self._timeout)
            except Exception as e:   # connection refused etc.
                raise TemporaryBackendError(
                    f"storage node {self._peer_ids[p]} unreachable: {e}") \
                    from e
            # probe_all connects peers concurrently; an unlocked
            # read-modify-write here could lose a False from a
            # non-TTL-capable peer
            with self._features_lock:
                self._cell_ttl = self._cell_ttl and mgr.features.cell_ttl
            # drain hints BEFORE publishing the peer: once it is visible,
            # new writes land direct, and raw storage nodes apply cells by
            # arrival order — a later replay of OLDER hinted cells would
            # overwrite them. The emptiness check and the publish are
            # atomic under _hints_lock (writers queue hints under the
            # same lock), so no hint can slip between them.
            while True:
                with self._hints_lock:
                    queued = self._hints.pop(p, None)
                    if not queued:
                        self._peers[p] = mgr
                        self._down.discard(p)
                        break
                self._replay_hints(p, mgr, queued)
        return mgr

    def _replay_hints(self, p: int, mgr: RemoteStoreManager,
                      queued: list) -> None:
        """Hinted handoff: deliver the mutations this peer missed while it
        was down. LWW cells make replay safe in any order/interleaving."""
        muts: dict[str, dict[bytes, KCVMutation]] = {}
        for store_name, key, mut in queued:
            slot = muts.setdefault(store_name, {})
            prev = slot.get(key)
            if prev is None:
                slot[key] = KCVMutation(list(mut.additions),
                                        list(mut.deletions))
            else:
                prev.additions.extend(mut.additions)
                prev.deletions.extend(mut.deletions)
        try:
            mgr.mutate_many(muts, StoreTransaction(None))
        except TemporaryBackendError:
            with self._hints_lock:   # re-queue, newest last
                self._hints.setdefault(p, [])[:0] = queued
            self._peers[p] = None
            self._down.add(p)
            raise

    def _queue_hint(self, p: int, store_name: str, key: bytes,
                    mut: KCVMutation) -> None:
        with self._hints_lock:
            q = self._hints.setdefault(p, [])
            if len(q) >= self._max_hints:
                # spilled hints converge later via forced merged reads +
                # the next full anti-entropy pass
                self._ever_overflowed.add(p)
                return
            q.append((store_name, key, mut))

    def mark_down(self, p: int) -> None:
        self._down.add(p)
        self._peers[p] = None

    def is_up(self, p: int) -> bool:
        if p not in self._down:
            return True
        try:   # one reconnect attempt per scan/operation that asks
            self.peer(p)
            return True
        except TemporaryBackendError:
            return False

    def require_scan_coverage(self, alive: Sequence[int]) -> None:
        """A scan is complete iff every key keeps >= 1 alive replica, i.e.
        fewer nodes are down than the replication factor — otherwise a
        'successful' scan would silently omit the dead nodes' keys."""
        down = self.num_peers - len(alive)
        if down >= self.ring.rf:
            raise TemporaryBackendError(
                f"{down} node(s) down with replication-factor "
                f"{self.ring.rf}: scan would be incomplete")

    def probe(self, p: int) -> bool:
        """Actively verify a peer answers (one cheap RPC); marks it down
        on failure. Scans use this because their generators are lazy."""
        try:
            self.peer(p)._call("/admin", {"op": "features"})
            return True
        except TemporaryBackendError:
            self.mark_down(p)
            return False

    def probe_all(self) -> list[int]:
        """Probe every peer CONCURRENTLY (a scan start previously paid
        num_peers serial HTTP round trips — worst case num_peers x the
        connect timeout when nodes are down)."""
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(16, self.num_peers)) as ex:
            up = list(ex.map(self.probe, range(self.num_peers)))
        return [p for p, ok in enumerate(up) if ok]

    # -- manager SPI ---------------------------------------------------------

    @property
    def name(self) -> str:
        return "remote-cluster"

    @property
    def features(self) -> StoreFeatures:
        # key_consistent: wc=all -> any replica read sees every acked
        # write; wc=quorum -> merged reads (the non-fast path) span a
        # quorum; wc=one with rf>1 genuinely cannot guarantee
        # read-your-writes, so the locking / id-claim layers must see
        # False (advisor finding: silently losing mutual exclusion)
        consistent = self.wc != "one" or self.ring.rf == 1
        return StoreFeatures(ordered_scan=True, unordered_scan=True,
                             key_ordered=True, distributed=True,
                             batch_mutation=True, multi_query=True,
                             key_consistent=consistent, persists=True,
                             cell_ttl=self._cell_ttl, timestamps=True)

    def open_database(self, name: str) -> ClusterStore:
        store = self._stores.get(name)
        if store is None:
            store = ClusterStore(self, name)
            self._stores[name] = store
        return store

    def begin_transaction(self, config=None) -> StoreTransaction:
        return StoreTransaction(config)

    def required_acks(self) -> int:
        rf = self.ring.rf
        return {"all": rf, "quorum": rf // 2 + 1, "one": 1}[self.wc]

    def _wrap_mutation(self, mut: KCVMutation, ts: int) -> KCVMutation:
        adds = []
        added_cols = set()
        now = time.time()
        for e in mut.additions:
            added_cols.add(bytes(e.column))
            ttl = entry_ttl(e)
            wrapped = _wrap(ts, e.value, expiry=(now + ttl) if ttl else 0.0)
            adds.append(TTLEntry(e.column, wrapped, ttl) if ttl
                        else Entry(e.column, wrapped))
        # deletions become tombstone cells so stale replicas can't
        # resurrect them during repair/merge. Same-batch add+delete of one
        # column gets IDENTICAL ts, and the raw-bytes tie-break would pick
        # the tombstone — inverting the KCVMutation.consolidate contract
        # (addition overrides deletion), so consolidate here instead.
        adds.extend(Entry(col, _wrap(ts, b"", tomb=True))
                    for col in mut.deletions
                    if bytes(col) not in added_cols)
        return KCVMutation(adds, [])

    def mutate_many(self, mutations: dict, txh) -> None:
        ts = self.next_ts()
        # build one batched payload per peer covering its replica share
        per_peer: dict[int, dict] = {}
        key_owners: list[tuple[tuple[int, ...], int]] = []
        wrapped_by_sk: dict[tuple[str, bytes], KCVMutation] = {}
        for store_name, by_key in mutations.items():
            for key, mut in by_key.items():
                owners = self.ring.replicas(key)
                key_owners.append((owners, len(owners)))
                wmut = self._wrap_mutation(mut, ts)
                wrapped_by_sk[(store_name, key)] = wmut
                for p in owners:
                    per_peer.setdefault(p, {}) \
                        .setdefault(store_name, {})[key] = wmut
        failed: set[int] = set()
        for p, muts in per_peer.items():
            try:
                self.peer(p).mutate_many(muts, txh)
            except TemporaryBackendError:
                failed.add(p)
                self.mark_down(p)
                for store_name, by_key in muts.items():
                    for key, wmut in by_key.items():
                        self._queue_hint(p, store_name, key, wmut)
        if failed:
            need = self.required_acks()
            for owners, _ in key_owners:
                acks = sum(1 for o in owners if o not in failed)
                if acks < need:
                    raise TemporaryBackendError(
                        f"write got {acks}/{need} acks (down: "
                        f"{[self._peer_ids[p] for p in sorted(failed)]})")

    def start_auto_compaction(self, interval_s: float,
                              grace_seconds: float) -> None:
        """Periodic anti-entropy + tombstone GC daemon (the role of
        Cassandra's scheduled compaction/repair; the reference delegates
        it to the store — SURVEY §2.7 replication row). Every
        ``interval_s`` seconds it runs ``compact_tombstones`` over the
        currently-open stores; a cycle is SKIPPED (counted, not fatal)
        while any replica is down or hints are undelivered — the same
        safety rules as the manual operation. Idempotent; stopped by
        ``close()``."""
        if interval_s <= 0 or self._compactor is not None:
            return
        self._compactor_stop = threading.Event()

        def loop():
            while not self._compactor_stop.wait(interval_s):
                names = list(self._stores)
                if not names:
                    continue
                try:
                    purged = self.compact_tombstones(
                        names, grace_seconds=grace_seconds)
                    self.compaction_stats["runs"] += 1
                    self.compaction_stats["purged"] += purged
                except TemporaryBackendError as e:
                    # replica down / hints queued: converge later
                    self.compaction_stats["skipped"] += 1
                    self.compaction_stats["last_error"] = str(e)
                except Exception as e:        # keep the daemon alive
                    self.compaction_stats["skipped"] += 1
                    self.compaction_stats["last_error"] = repr(e)

        self._compactor = threading.Thread(
            target=loop, name="cluster-compaction", daemon=True)
        self._compactor.start()

    def close(self) -> None:
        if self._compactor_stop is not None:
            self._compactor_stop.set()
        if self._compactor is not None:
            self._compactor.join(timeout=5.0)
            self._compactor = None
        for mgr in self._peers:
            if mgr is not None:
                mgr.close()

    def compact_tombstones(self, store_names: Sequence[str],
                           grace_seconds: float = 0.0) -> int:
        """Full anti-entropy pass + tombstone GC (the Cassandra repair +
        gc_grace compaction roles): first every key is LWW-merged across
        all replicas and stale replicas repaired — this DELIVERS any
        tombstones a replica missed, including hints dropped by queue
        overflow — then tombstone cells older than ``grace_seconds`` are
        deleted everywhere.

        A maintenance operation for quiescent windows (like nodetool
        repair/compact): refuses to run unless every replica is up (a
        down replica cannot be synced, and purging its suppressing
        tombstones would resurrect its stale cells on revival), and
        refuses while undelivered hints are queued. Concurrent writers
        narrow-race the purge (the delete is not compare-and-set), so
        each candidate column is re-read immediately before deletion and
        skipped if the cell changed. Returns the number of tombstone
        cells purged."""
        alive = self.probe_all()
        if len(alive) < self.num_peers:
            raise TemporaryBackendError(
                "tombstone compaction needs every replica up (a down "
                "replica may hold stale cells the tombstones suppress)")
        with self._hints_lock:
            if self._hints:
                raise TemporaryBackendError(
                    "tombstone compaction refused: undelivered hints mean "
                    "a replica may still be missing tombstones")
        cutoff = time.time_ns() - int(grace_seconds * 1e9)
        txh = StoreTransaction(None)
        purged = 0
        for name in store_names:
            store = self.open_database(name)
            # phase 1 — full sync: union of keys over all replicas, each
            # merged + repaired (missed tombstones land here)
            keys: set[bytes] = set()
            for p in alive:
                raw = self.peer(p).open_database(name)
                for key, _ in raw.get_keys(SliceQuery(), txh):
                    keys.add(key)
            for key in keys:
                rows = store._read_replicas(
                    KeySliceQuery(key, SliceQuery()), txh)
                _, repairs = _merge_cells(rows)
                store._apply_repairs({None: repairs}, {None: key}, txh)
            # phase 2 — purge expired tombstones from every replica
            for p in alive:
                raw = self.peer(p).open_database(name)
                for key, entries in raw.get_keys(SliceQuery(), txh):
                    cand = {}
                    for e in entries:
                        ts, tomb, _, _ = _unwrap(e.value)
                        if tomb and ts < cutoff:
                            cand[e.column] = e.value
                    if not cand:
                        continue
                    # re-read just before the purge: only delete cells
                    # still byte-identical to the observed tombstone
                    fresh = {e.column: e.value for e in raw.get_slice(
                        KeySliceQuery(key, SliceQuery()), txh)}
                    dead = [col for col, v in cand.items()
                            if fresh.get(col) == v]
                    if dead:
                        raw.mutate(key, [], dead, txh)
                        purged += len(dead)
        # every key on every replica is now synced: the overflow taint is
        # legitimately cleared
        with self._hints_lock:
            self._ever_overflowed.clear()
        return purged

    def clear_storage(self) -> None:
        for p in range(self.num_peers):
            self.peer(p).clear_storage()

    def exists(self) -> bool:
        for p in range(self.num_peers):
            try:
                if self.peer(p).exists():
                    return True
            except TemporaryBackendError:
                continue
        return False
