"""Storage/index backend registry.

(reference: titan-core diskstorage/StandardStoreManager.java:12-18,
Backend.getStorageManager Backend.java:406-414 — shorthand → implementation
map with reflective fallback to an import path.)

The port's copy registers what the JAX package's does: ``inmemory``,
``sqlite``, ``gdbm`` (``storage/gdbmkv.py``), ``remote`` (one storage
node, ``storage/remote.py``) and ``remote-cluster`` (storage nodes behind
a hash ring, ``storage/cluster.py``). An import path under the JAX
package or JAX is refused before any import.
"""

from __future__ import annotations

import importlib
from typing import Callable

from titan_tpu_torch.errors import refuse_foreign

_STORE_FACTORIES: dict[str, Callable] = {}


def register_store(shorthand: str, factory: Callable) -> None:
    _STORE_FACTORIES[shorthand] = factory


def store_manager(shorthand: str, **kwargs):
    factory = _STORE_FACTORIES.get(shorthand)
    if factory is not None:
        return factory(**kwargs)
    if "." in shorthand:  # import path "pkg.mod.Class"
        refuse_foreign(shorthand, "storage.backend")
        mod, _, cls = shorthand.rpartition(".")
        ctor = getattr(importlib.import_module(mod), cls)
        # plugins only receive the kwargs their constructor declares (the
        # Backend passes the full connection set: directory/hostname/...)
        import inspect
        sig = inspect.signature(ctor.__init__ if inspect.isclass(ctor)
                                else ctor)
        params = sig.parameters.values()
        if not any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params):
            accepted = {p.name for p in params}
            kwargs = {k: v for k, v in kwargs.items() if k in accepted}
        return ctor(**kwargs)
    raise ValueError(f"unknown storage backend {shorthand!r}; known: "
                     f"{sorted(_STORE_FACTORIES)}")


def _inmemory(**kw):
    from titan_tpu_torch.storage.inmemory import InMemoryStoreManager
    return InMemoryStoreManager()


def _sqlite(directory=None, read_only=False, **kw):
    from titan_tpu_torch.storage.sqlitekv import SqliteStoreManager
    return SqliteStoreManager(directory, read_only)


def _remote(hostname=None, port=None, timeout=None, **kw):
    from titan_tpu_torch.storage.remote import RemoteStoreManager
    # storage.hostname is a host LIST (reference parity); this adapter
    # targets one storage node
    if isinstance(hostname, (list, tuple)):
        hostname = hostname[0] if hostname else None
    return RemoteStoreManager(hostname or "127.0.0.1", int(port or 8283),
                              timeout=float(timeout or 30.0))


def _remote_cluster(hostname=None, port=None, replication=None,
                    write_consistency=None, virtual_nodes=None,
                    read_repair=None, max_hints_per_peer=None,
                    timeout=None, **kw):
    from titan_tpu_torch.storage.cluster import (MAX_HINTS_PER_PEER,
                                                 ClusterStoreManager)
    hosts = hostname if isinstance(hostname, (list, tuple)) \
        else ([hostname] if hostname else [])
    return ClusterStoreManager(list(hosts), int(port or 8283),
                               int(replication or 1),
                               write_consistency or "all",
                               int(virtual_nodes or 64),
                               timeout=float(timeout or 30.0),
                               read_repair=(0.1 if read_repair is None
                                            else float(read_repair)),
                               max_hints_per_peer=int(
                                   max_hints_per_peer
                                   or MAX_HINTS_PER_PEER))


def _gdbm(directory=None, **kw):
    from titan_tpu_torch.storage.gdbmkv import GdbmStoreManager
    return GdbmStoreManager(directory)


register_store("inmemory", _inmemory)
register_store("sqlite", _sqlite)
register_store("gdbm", _gdbm)
register_store("remote", _remote)
register_store("remote-cluster", _remote_cluster)
