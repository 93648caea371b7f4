"""Storage/index backend registry.

(reference: titan-core diskstorage/StandardStoreManager.java:12-18,
Backend.getStorageManager Backend.java:406-414 — shorthand → implementation
map with reflective fallback to an import path.)

The port's copy registers ``inmemory``, ``sqlite`` and ``remote`` (one
storage node, ``storage/remote.py``); ``gdbm`` and ``remote-cluster``
raise ``NotImplementedError`` naming ROADMAP queue 1, item 11.
"""

from __future__ import annotations

import importlib
from typing import Callable

from titan_tpu_torch.errors import not_ported

_STORE_FACTORIES: dict[str, Callable] = {}


def register_store(shorthand: str, factory: Callable) -> None:
    _STORE_FACTORIES[shorthand] = factory


def store_manager(shorthand: str, **kwargs):
    factory = _STORE_FACTORIES.get(shorthand)
    if factory is not None:
        return factory(**kwargs)
    if "." in shorthand:  # import path "pkg.mod.Class"
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


def _not_ported(shorthand: str):
    def refuse(**kw):
        raise not_ported(f"storage.backend={shorthand!r}")
    return refuse


register_store("inmemory", _inmemory)
register_store("sqlite", _sqlite)
register_store("remote", _remote)
for _name in ("gdbm", "remote-cluster"):
    register_store(_name, _not_ported(_name))
