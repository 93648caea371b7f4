"""Configuration views over raw key→value data.

Re-creation of the reference's BasicConfiguration / ModifiableConfiguration /
MergedConfiguration stack (reference: titan-core
diskstorage/configuration/BasicConfiguration.java,
ModifiableConfiguration.java, MergedConfiguration.java): a read view binds a
raw dotted-path→value mapping to the typed option tree and enforces
restrictions (a GLOBAL-restricted view refuses LOCAL options and vice versa);
a modifiable view additionally enforces mutability on ``set``.

The cluster-global configuration that the reference stores *inside* the
storage backend (KCVSConfiguration over the ``system_properties`` store,
Backend.java:273-298) is provided by storage/config_store.py using the same
ReadConfiguration/WriteConfiguration contracts defined here.
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Iterable, Iterator, Optional

from titan_tpu_torch.config.options import (ConfigNamespace, ConfigOption, Mutability, SEPARATOR)


class ReadConfiguration:
    """Raw read view: dotted path → value (strings allowed, coerced later)."""

    def get(self, key: str) -> Any:
        raise NotImplementedError

    def keys(self, prefix: str = "") -> Iterable[str]:
        raise NotImplementedError


class WriteConfiguration(ReadConfiguration):
    def set(self, key: str, value: Any) -> None:
        raise NotImplementedError

    def remove(self, key: str) -> None:
        raise NotImplementedError


class MapConfiguration(WriteConfiguration):
    """Dict-backed raw configuration (thread-safe)."""

    def __init__(self, data: Optional[dict] = None):
        self._data = dict(data or {})
        self._lock = threading.RLock()

    def get(self, key: str) -> Any:
        with self._lock:
            return self._data.get(key)

    def keys(self, prefix: str = "") -> list[str]:
        with self._lock:
            return [k for k in self._data if k.startswith(prefix)]

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = value

    def remove(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def as_dict(self) -> dict:
        with self._lock:
            return dict(self._data)


class Restriction(enum.Enum):
    NONE = "NONE"      # accept any option
    LOCAL = "LOCAL"    # only LOCAL/MASKABLE options visible
    GLOBAL = "GLOBAL"  # only GLOBAL* / FIXED options visible


class Configuration:
    """Typed read view over a ReadConfiguration bound to an option tree root."""

    def __init__(self, root: ConfigNamespace, raw: ReadConfiguration,
                 restriction: Restriction = Restriction.NONE):
        if not root.is_root():
            raise ValueError("configuration must be bound to the tree root")
        self.root = root
        self.raw = raw
        self.restriction = restriction

    # -- option resolution --------------------------------------------------

    def _check_restriction(self, opt: ConfigOption):
        if self.restriction is Restriction.LOCAL and not opt.mutability.is_local:
            raise ValueError(f"option {opt.name!r} is not local-mutable")
        if self.restriction is Restriction.GLOBAL and not opt.mutability.is_global:
            raise ValueError(f"option {opt.name!r} is not global")

    def has(self, opt: ConfigOption, *umbrella: str) -> bool:
        return self.raw.get(opt.path(*umbrella)) is not None

    def get(self, opt: ConfigOption, *umbrella: str) -> Any:
        self._check_restriction(opt)
        value = self.raw.get(opt.path(*umbrella))
        if value is None:
            return opt.default
        return opt.validate(value)

    def get_subset(self, namespace: ConfigNamespace, *umbrella: str) -> dict:
        """All raw entries under a namespace path, keys relative to it."""
        prefix = namespace._build_path(list(umbrella)) + SEPARATOR
        out = {}
        for key in self.raw.keys(prefix):
            out[key[len(prefix):]] = self.raw.get(key)
        return out

    def container_names(self, umbrella_ns: ConfigNamespace, *umbrella: str) -> list[str]:
        """User-chosen middle elements configured under an umbrella namespace
        (e.g. the index names under ``index.<name>``)."""
        if not umbrella_ns.is_umbrella:
            raise ValueError(f"{umbrella_ns.name!r} is not an umbrella namespace")
        parent = umbrella_ns.parent
        if parent is None or parent.is_root():
            base = umbrella_ns.name
        else:
            base = parent._build_path(list(umbrella)) + SEPARATOR + umbrella_ns.name
        prefix = base + SEPARATOR
        names = set()
        for key in self.raw.keys(prefix):
            rest = key[len(prefix):]
            if SEPARATOR in rest:
                names.add(rest.split(SEPARATOR, 1)[0])
        return sorted(names)

    def resolve_option(self, path: str) -> tuple[ConfigOption, list[str]]:
        """Map a dotted path back to (option, umbrella elements). Raises
        KeyError for unknown paths (reference: ConfigElement.parse)."""
        parts = path.split(SEPARATOR)
        node: ConfigNamespace = self.root
        umbrella: list[str] = []
        i = 0
        while i < len(parts):
            child = node.child(parts[i])
            if child is None:
                raise KeyError(f"unknown config path: {path!r} (at {parts[i]!r})")
            if isinstance(child, ConfigOption):
                if i != len(parts) - 1:
                    raise KeyError(f"config path continues past option: {path!r}")
                return child, umbrella
            assert isinstance(child, ConfigNamespace)
            node = child
            i += 1
            if node.is_umbrella:
                if i >= len(parts):
                    raise KeyError(f"umbrella namespace path truncated: {path!r}")
                umbrella.append(parts[i])
                i += 1
        raise KeyError(f"config path names a namespace, not an option: {path!r}")


class ModifiableConfiguration(Configuration):
    """Typed write view; enforces mutability levels on set()."""

    def __init__(self, root: ConfigNamespace, raw: WriteConfiguration,
                 restriction: Restriction = Restriction.NONE):
        super().__init__(root, raw, restriction)
        self.raw: WriteConfiguration = raw

    def set(self, opt: ConfigOption, value: Any, *umbrella: str,
            force: bool = False) -> None:
        self._check_restriction(opt)
        if not force:
            if opt.mutability is Mutability.FIXED:
                raise ValueError(f"option {opt.name!r} is FIXED and cannot be changed")
            if opt.mutability is Mutability.GLOBAL_OFFLINE:
                raise ValueError(
                    f"option {opt.name!r} is GLOBAL_OFFLINE; use the management "
                    f"system with all instances closed")
        value = opt.validate(value)
        self.raw.set(opt.path(*umbrella), value)

    def remove(self, opt: ConfigOption, *umbrella: str) -> None:
        self._check_restriction(opt)
        self.raw.remove(opt.path(*umbrella))


class MergedConfiguration(Configuration):
    """first (typically local) masks second (typically global), respecting
    mutability: for GLOBAL* options the *second* (global) wins unless the
    option is MASKABLE (reference: MergedConfiguration + the merge logic in
    GraphDatabaseConfiguration's constructor)."""

    def __init__(self, first: Configuration, second: Configuration):
        if first.root is not second.root:
            raise ValueError("merged configurations must share an option tree")
        super().__init__(first.root, first.raw, Restriction.NONE)
        self.first = first
        self.second = second

    def has(self, opt: ConfigOption, *umbrella: str) -> bool:
        return self.first.has(opt, *umbrella) or self.second.has(opt, *umbrella)

    def get(self, opt: ConfigOption, *umbrella: str) -> Any:
        first_has = self.first.has(opt, *umbrella)
        second_has = self.second.has(opt, *umbrella)
        if opt.mutability.is_global and not (opt.mutability is Mutability.MASKABLE):
            # global value authoritative when present
            if second_has:
                return self.second.get(opt, *umbrella)
            if first_has:
                return self.first.get(opt, *umbrella)
        else:
            if first_has:
                return self.first.get(opt, *umbrella)
            if second_has:
                return self.second.get(opt, *umbrella)
        return opt.default

    def get_subset(self, namespace: ConfigNamespace, *umbrella: str) -> dict:
        out = self.second.get_subset(namespace, *umbrella)
        out.update(self.first.get_subset(namespace, *umbrella))
        return out

    def container_names(self, umbrella_ns: ConfigNamespace, *umbrella: str) -> list[str]:
        names = set(self.first.container_names(umbrella_ns, *umbrella))
        names.update(self.second.container_names(umbrella_ns, *umbrella))
        return sorted(names)
