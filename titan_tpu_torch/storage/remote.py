"""Remote KCVS: a storage server speaking the KCVS contract over HTTP, and
the client adapter that mounts it as a backend (the port's copy of
``titan_tpu/storage/remote.py``; the wire is the same JSON, so either
package's client talks to either package's node).

This is the distributed-backend tier (reference: titan-cassandra's thrift
socket adapter, CassandraThriftStoreManager/CassandraThriftKeyColumnValue-
Store + CTConnectionPool, and titan-hbase's client RPC — an external
storage SERVICE reached over the network, with Titan layering consistent-
key locking and the id-authority claim protocol on top because the remote
store exposes no transactions). Here both halves are in-process Python:

* ``KCVSServer`` hosts any local store manager (sqlite for durability,
  inmemory for tests) behind JSON/base64 HTTP endpoints — the storage
  node.
* ``RemoteStoreManager`` implements the KCVS SPI by calling those
  endpoints — the graph-instance side. Mutations batch client-side (the
  BackendTransaction buffers) and ship as ONE mutate-many RPC per commit,
  exactly like the reference's batched thrift calls. StoreFeatures
  declare key-consistent, non-transactional storage, so the stock
  locking/id-authority protocols engage unchanged.

Scan iteration pages by key cursor so OLAP snapshot builds stream without
the server materializing the store. TTLs travel with each entry.
"""

from __future__ import annotations

import base64
from typing import Iterator, Optional, Sequence

from titan_tpu_torch.errors import PermanentBackendError
from titan_tpu_torch.utils.httpnode import JsonNode, json_call, run_node_cli
from titan_tpu_torch.storage.api import (Entry, EntryList, KCVMutation,
                                   KeyColumnValueStore,
                                   KeyColumnValueStoreManager, KeyRangeQuery,
                                   KeySliceQuery, SliceQuery, StoreFeatures,
                                   StoreTransaction, TTLEntry, entry_ttl)

_SCAN_PAGE = 512


def _b(x: Optional[bytes]) -> Optional[str]:
    return None if x is None else base64.b64encode(x).decode()


def _ub(x: Optional[str]) -> Optional[bytes]:
    return None if x is None else base64.b64decode(x)


def _enc_entry(e) -> list:
    ttl = entry_ttl(e)
    return [_b(e.column), _b(e.value)] + ([ttl] if ttl else [])


def _dec_entry(row) -> Entry:
    if len(row) > 2 and row[2]:
        return TTLEntry(_ub(row[0]), _ub(row[1]), row[2])
    return Entry(_ub(row[0]), _ub(row[1]))


def _enc_slice(q: SliceQuery) -> dict:
    return {"start": _b(q.start), "end": _b(q.end), "limit": q.limit}


def _dec_slice(d: dict) -> SliceQuery:
    return SliceQuery(_ub(d["start"]) or b"", _ub(d.get("end")),
                      d.get("limit"))


class KCVSServer(JsonNode):
    """Hosts a local store manager as a storage node."""

    def __init__(self, manager: KeyColumnValueStoreManager,
                 host: str = "127.0.0.1", port: int = 0):
        super().__init__(self._dispatch, host, port, name="kcvs-node")
        self.manager = manager

    def _dispatch(self, path: str, req: dict):
        mgr = self.manager
        txh = mgr.begin_transaction()
        try:
            if path == "/slice":
                store = mgr.open_database(req["store"])
                entries = store.get_slice(
                    KeySliceQuery(_ub(req["key"]),
                                  _dec_slice(req["slice"])), txh)
                return {"entries": [[_b(e.column), _b(e.value)]
                                    for e in entries]}
            if path == "/slice_multi":
                store = mgr.open_database(req["store"])
                res = store.get_slice_multi(
                    [_ub(k) for k in req["keys"]],
                    _dec_slice(req["slice"]), txh)
                return {"rows": [[_b(k), [[_b(e.column), _b(e.value)]
                                          for e in v]]
                                 for k, v in res.items()]}
            if path == "/mutate_many":
                muts = {}
                for store_name, by_key in req["mutations"].items():
                    m = muts.setdefault(store_name, {})
                    for k, (adds, dels) in by_key.items():
                        m[_ub(k)] = KCVMutation(
                            [_dec_entry(a) for a in adds],
                            [_ub(c) for c in dels])
                try:
                    mgr.mutate_many(muts, txh)
                    txh.commit()
                except BaseException:
                    # an abandoned write tx would pin the node's
                    # write lock until GC
                    txh.rollback()
                    raise
                return {"ok": True}
            if path == "/scan_page":
                store = mgr.open_database(req["store"])
                sl = _dec_slice(req["slice"])
                after = _ub(req.get("after"))
                lo = _ub(req.get("key_start")) or b""
                hi = _ub(req.get("key_end"))   # None = unbounded
                if after is not None and after >= lo:
                    lo = after + b"\x00"
                q = KeyRangeQuery(lo, hi, sl)
                rows = []
                for key, entries in store.get_keys(q, txh):
                    rows.append([_b(key), [[_b(e.column), _b(e.value)]
                                           for e in entries]])
                    if len(rows) >= _SCAN_PAGE:
                        break
                return {"rows": rows,
                        "done": len(rows) < _SCAN_PAGE}
            if path == "/admin":
                op = req["op"]
                if op == "clear":
                    mgr.clear_storage()
                    return {"ok": True}
                if op == "exists":
                    return {"exists": mgr.exists()}
                if op == "features":
                    f = mgr.features
                    return {"cell_ttl": f.cell_ttl}
                raise PermanentBackendError(f"unknown admin op {op!r}")
            raise PermanentBackendError(f"unknown endpoint {path!r}")
        finally:
            if path != "/mutate_many":
                txh.commit()

# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

class RemoteStore(KeyColumnValueStore):
    def __init__(self, manager: "RemoteStoreManager", name: str):
        self._manager = manager
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def get_slice(self, query: KeySliceQuery,
                  txh: StoreTransaction) -> EntryList:
        res = self._manager._call("/slice", {
            "store": self._name, "key": _b(query.key),
            "slice": _enc_slice(query.slice)})
        return [Entry(_ub(c), _ub(v)) for c, v in res["entries"]]

    def get_slice_multi(self, keys: Sequence[bytes], slice_query: SliceQuery,
                        txh: StoreTransaction) -> dict:
        res = self._manager._call("/slice_multi", {
            "store": self._name, "keys": [_b(k) for k in keys],
            "slice": _enc_slice(slice_query)})
        return {_ub(k): [Entry(_ub(c), _ub(v)) for c, v in entries]
                for k, entries in res["rows"]}

    def mutate(self, key: bytes, additions: Sequence[Entry],
               deletions: Sequence[bytes], txh: StoreTransaction) -> None:
        self._manager.mutate_many(
            {self._name: {key: KCVMutation(list(additions), list(deletions))}},
            txh)

    def get_keys(self, query, txh: StoreTransaction) -> Iterator:
        if isinstance(query, KeyRangeQuery):
            key_start, key_end = query.key_start, query.key_end
            sl = query.slice
            key_limit = query.key_limit
        else:
            key_start, key_end, sl = b"", None, query
            key_limit = None
        after = None
        yielded = 0
        while True:
            res = self._manager._call("/scan_page", {
                "store": self._name, "slice": _enc_slice(sl),
                "after": _b(after), "key_start": _b(key_start),
                "key_end": _b(key_end)})
            for k, entries in res["rows"]:
                key = _ub(k)
                after = key
                yield key, [Entry(_ub(c), _ub(v)) for c, v in entries]
                yielded += 1
                if key_limit is not None and yielded >= key_limit:
                    return
            if res["done"]:
                return


class RemoteStoreManager(KeyColumnValueStoreManager):
    """``storage.backend=remote`` with ``storage.hostname`` and
    ``storage.port``."""

    def __init__(self, hostname: str = "127.0.0.1", port: int = 8283,
                 timeout: float = 30.0, **_kw):
        self._url = f"http://{hostname}:{port}"
        self._timeout = timeout
        self._stores: dict[str, RemoteStore] = {}
        # one features RPC up front: TTL capability follows the server's
        # backing store
        feats = self._call("/admin", {"op": "features"})
        self._cell_ttl = bool(feats.get("cell_ttl"))

    def _call(self, path: str, payload: dict) -> dict:
        return json_call(self._url, path, payload, timeout=self._timeout)

    @property
    def name(self) -> str:
        return "remote"

    @property
    def features(self) -> StoreFeatures:
        # the reference's eventually-consistent-adapter shape: no native
        # transactions/locking, batched mutations, key-consistent reads —
        # so consistent-key locking and the id-authority claim protocol
        # layer on top unchanged
        return StoreFeatures(ordered_scan=True, unordered_scan=True,
                             key_ordered=True, distributed=True,
                             batch_mutation=True, multi_query=True,
                             key_consistent=True, persists=True,
                             cell_ttl=self._cell_ttl)

    def open_database(self, name: str) -> RemoteStore:
        store = self._stores.get(name)
        if store is None:
            store = RemoteStore(self, name)
            self._stores[name] = store
        return store

    def begin_transaction(self, config=None) -> StoreTransaction:
        return StoreTransaction(config)

    def mutate_many(self, mutations: dict, txh: StoreTransaction) -> None:
        payload = {}
        for store_name, by_key in mutations.items():
            m = payload.setdefault(store_name, {})
            for key, mut in by_key.items():
                m[_b(key)] = [[_enc_entry(e) for e in mut.additions],
                              [_b(c) for c in mut.deletions]]
        self._call("/mutate_many", {"mutations": payload})

    def close(self) -> None:
        pass

    def clear_storage(self) -> None:
        self._call("/admin", {"op": "clear"})

    def exists(self) -> bool:
        return bool(self._call("/admin", {"op": "exists"})["exists"])


def main(argv: Optional[list] = None) -> None:
    """``python -m titan_tpu_torch.storage.remote <data-dir> [port]
    [host]`` —
    run a storage node (sqlite-backed, binds 0.0.0.0 by default so remote
    graph instances can reach it) mounted with ``storage.backend=remote``."""
    def make(directory, host, port):
        from titan_tpu_torch.storage.sqlitekv import SqliteStoreManager
        return KCVSServer(SqliteStoreManager(directory), host=host,
                          port=port or 8283)
    run_node_cli(argv, "usage: python -m titan_tpu_torch.storage.remote "
                       "<data-dir> [port] [host]", make)


if __name__ == "__main__":
    main()
