"""Write-ahead transaction log + recovery (the port's copy of
``titan_tpu/core/wal.py``).

(reference: titan-core graphdb/database/StandardTitanGraph.java:657-772 — the
commit path logs PRECOMMIT (serialized mutations), then PRIMARY_SUCCESS
atomically-adjacent to the storage commit, then SECONDARY_SUCCESS/FAILURE
after index/trigger writes; graphdb/log/StandardTransactionLogProcessor.java:57
replays the log and re-applies lost secondary (index) writes for transactions
whose primary succeeded but secondary persistence failed.)

Record format (payload via the self-describing serializer):
    [txid u64][status u8][dict payload]
payload = {store_name: {key: [[(col, val), ...], [col, ...]]}}
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from titan_tpu_torch.codec.attributes import Serializer
from titan_tpu_torch.storage.log import KCVSLog, LogMessage, ReadMarker

PRECOMMIT = 1
PRIMARY_SUCCESS = 2
SECONDARY_SUCCESS = 3
SECONDARY_FAILURE = 4

_STATUS_NAMES = {1: "PRECOMMIT", 2: "PRIMARY_SUCCESS",
                 3: "SECONDARY_SUCCESS", 4: "SECONDARY_FAILURE"}


class TransactionLog:
    """Writer side, used by the graph commit path."""

    def __init__(self, log: KCVSLog, serializer: Optional[Serializer] = None):
        self._log = log
        self._ser = serializer or Serializer()
        # random high bits make txids unique across instances sharing the
        # txlog (a time-seeded counter collides when two instances open in
        # the same millisecond, corrupting recovery bookkeeping)
        import os as _os
        self._txid_counter = (int.from_bytes(_os.urandom(8), "big") >> 1) \
            & ~0xFFFFF
        self._lock = threading.Lock()

    def next_txid(self) -> int:
        with self._lock:
            self._txid_counter += 1
            return self._txid_counter

    def _record(self, txid: int, status: int, payload: Optional[dict] = None
                ) -> bytes:
        body = txid.to_bytes(8, "big") + bytes([status])
        if payload is not None:
            body += self._ser.value_bytes(payload)
        return body

    def log_precommit(self, txid: int, mutations: dict) -> None:
        """mutations: {store: {key(bytes): (additions [(col,val)...],
        deletions [col...])}} — serialized so recovery can re-apply."""
        payload = {store: {key: [[list(e) for e in adds], list(dels)]
                           for key, (adds, dels) in by_key.items()}
                   for store, by_key in mutations.items()}
        self._log.add(self._record(txid, PRECOMMIT, payload))

    def log_primary_success(self, txid: int) -> None:
        self._log.add(self._record(txid, PRIMARY_SUCCESS))

    def log_secondary_success(self, txid: int) -> None:
        self._log.add(self._record(txid, SECONDARY_SUCCESS))

    def log_secondary_failure(self, txid: int) -> None:
        self._log.add(self._record(txid, SECONDARY_FAILURE))

    def parse(self, msg: LogMessage) -> tuple[int, int, Optional[dict]]:
        body = msg.content
        txid = int.from_bytes(body[:8], "big")
        status = body[8]
        payload = None
        if len(body) > 9:
            payload = self._ser.value_from_bytes(body[9:])
        return txid, status, payload


class TransactionRecovery:
    """Replays the tx log and re-applies lost SECONDARY (index-store) writes.
    (reference: StandardTransactionLogProcessor; started via
    TitanFactory.startTransactionRecovery)"""

    SECONDARY_STORES = ("graphindex",)

    def __init__(self, graph, txlog: KCVSLog, start_time: Optional[int] = None,
                 persistence_timeout_s: float = 2.0):
        self.graph = graph
        self._txlog = txlog
        self._wal = TransactionLog(txlog, graph.serializer)
        self._timeout = persistence_timeout_s
        self._pending: dict[int, dict] = {}  # txid -> {payload, primary, t}
        self._lock = threading.Lock()
        self.recovered = 0
        self._txlog.register_reader(
            ReadMarker(identifier="recovery", start_time=start_time),
            self._on_message)

    def _on_message(self, msg: LogMessage) -> None:
        txid, status, payload = self._wal.parse(msg)
        with self._lock:
            entry = self._pending.setdefault(
                txid, {"payload": None, "primary": False,
                       "t": time.monotonic()})
            if status == PRECOMMIT:
                entry["payload"] = payload
            elif status == PRIMARY_SUCCESS:
                entry["primary"] = True
            elif status == SECONDARY_SUCCESS:
                self._pending.pop(txid, None)
            elif status == SECONDARY_FAILURE:
                entry["primary"] = True  # definitely needs secondary replay
        self._sweep()

    def _sweep(self) -> None:
        now = time.monotonic()
        replay = []
        with self._lock:
            for txid, entry in list(self._pending.items()):
                if entry["primary"] and entry["payload"] is not None and \
                        now - entry["t"] >= self._timeout:
                    replay.append((txid, entry["payload"]))
                    del self._pending[txid]
                elif not entry["primary"] and \
                        now - entry["t"] >= 10 * self._timeout:
                    # primary never confirmed: tx failed before storage
                    # commit — nothing to repair
                    del self._pending[txid]
        for txid, payload in replay:
            self._replay_secondary(txid, payload)

    def force_sweep(self) -> None:
        """Test/shutdown helper: replay everything eligible right now."""
        with self._lock:
            for entry in self._pending.values():
                entry["t"] = -1e18
        self._sweep()

    def _replay_secondary(self, txid: int, payload: dict) -> None:
        from titan_tpu_torch.storage.api import Entry
        backend = self.graph.backend
        txh = backend.manager.begin_transaction()
        try:
            for store_name, by_key in payload.items():
                if store_name not in self.SECONDARY_STORES:
                    continue
                store = backend.manager.open_database(store_name)
                for key, (adds, dels) in by_key.items():
                    # a third element is the cell TTL (TTLEntry rows) —
                    # preserve it so recovered cells still expire (the clock
                    # restarts at replay time: at-least-lifetime semantics)
                    from titan_tpu_torch.storage.api import TTLEntry
                    store.mutate(
                        key,
                        [TTLEntry(a[0], a[1], a[2]) if len(a) > 2 and a[2]
                         else Entry(a[0], a[1]) for a in adds],
                        list(dels), txh)
            txh.commit()
            self.recovered += 1
        except BaseException:
            txh.rollback()
            raise
