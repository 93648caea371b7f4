"""Typed hierarchical configuration tree.

Re-creation of the reference's distinctive config kernel
(reference: titan-core diskstorage/configuration/ConfigOption.java,
ConfigNamespace.java, ConfigElement.java): a tree of namespaces holding typed
options, each with a datatype, default, verification function and a
*mutability level* that governs where the value may be changed:

    LOCAL          — only via local config at open time
    MASKABLE       — local config may override the cluster-global value
    GLOBAL         — cluster-wide, changed online through management
    GLOBAL_OFFLINE — cluster-wide, all instances must be down to change
    FIXED          — set once at cluster initialization, immutable after

Umbrella namespaces (``index.<name>.backend``) carry a user-chosen middle
path element, exactly like the reference's ``ConfigNamespace(isUmbrella)``.
"""

from __future__ import annotations

import enum
import re
from typing import Any, Callable, Optional, Sequence


class Mutability(enum.Enum):
    LOCAL = "LOCAL"
    MASKABLE = "MASKABLE"
    GLOBAL = "GLOBAL"
    GLOBAL_OFFLINE = "GLOBAL_OFFLINE"
    FIXED = "FIXED"

    @property
    def is_global(self) -> bool:
        return self in (Mutability.GLOBAL, Mutability.GLOBAL_OFFLINE, Mutability.FIXED)

    @property
    def is_local(self) -> bool:
        return self in (Mutability.LOCAL, Mutability.MASKABLE)

    def is_stricter_or_equal(self, other: "Mutability") -> bool:
        order = [Mutability.LOCAL, Mutability.MASKABLE, Mutability.GLOBAL,
                 Mutability.GLOBAL_OFFLINE, Mutability.FIXED]
        return order.index(self) >= order.index(other)


_NAME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9_-]*$")
SEPARATOR = "."


class ConfigElement:
    """A node in the config tree; path = dotted names from the root."""

    def __init__(self, parent: Optional["ConfigNamespace"], name: str, description: str = ""):
        if parent is not None and not _NAME_RE.match(name):
            raise ValueError(f"invalid config element name: {name!r}")
        self.parent = parent
        self.name = name
        self.description = description
        if parent is not None:
            parent._register(self)

    def is_root(self) -> bool:
        return self.parent is None

    @property
    def root(self) -> "ConfigNamespace":
        el = self
        while el.parent is not None:
            el = el.parent
        assert isinstance(el, ConfigNamespace)
        return el

    def path(self, *umbrella_elements: str) -> str:
        """Full dotted path; umbrella elements fill umbrella namespaces
        top-down (same contract as the reference's ConfigElement.getPath)."""
        return self._build_path(list(umbrella_elements))

    def _build_path(self, fills: list[str]) -> str:
        chain: list[ConfigElement] = []
        el: Optional[ConfigElement] = self
        while el is not None and not el.is_root():
            chain.append(el)
            el = el.parent
        chain.reverse()
        parts: list[str] = []
        fi = 0
        for node in chain:
            parts.append(node.name)
            if isinstance(node, ConfigNamespace) and node.is_umbrella:
                if fi >= len(fills):
                    raise ValueError(
                        f"missing umbrella element under namespace {node.name!r} "
                        f"for {self.name!r}")
                parts.append(fills[fi])
                fi += 1
        if fi != len(fills):
            raise ValueError(f"too many umbrella elements for {self.name!r}")
        return SEPARATOR.join(parts)

    def __repr__(self):
        try:
            return f"<{type(self).__name__} {self._build_path(['*'] * self._umbrella_depth())}>"
        except ValueError:
            return f"<{type(self).__name__} {self.name}>"

    def _umbrella_depth(self) -> int:
        """Number of umbrella fills needed to path to this element (counting
        the element itself if it is an umbrella namespace)."""
        n = 0
        el: Optional[ConfigElement] = self
        while el is not None and not el.is_root():
            if isinstance(el, ConfigNamespace) and el.is_umbrella:
                n += 1
            el = el.parent
        return n


class ConfigNamespace(ConfigElement):
    def __init__(self, parent: Optional["ConfigNamespace"], name: str,
                 description: str = "", umbrella: bool = False):
        self.is_umbrella = umbrella
        self._children: dict[str, ConfigElement] = {}
        super().__init__(parent, name, description)

    def _register(self, child: ConfigElement):
        if child.name in self._children:
            raise ValueError(f"duplicate config element {child.name!r} in {self.name!r}")
        self._children[child.name] = child

    def child(self, name: str) -> Optional[ConfigElement]:
        return self._children.get(name)

    def children(self) -> Sequence[ConfigElement]:
        return list(self._children.values())


class ConfigOption(ConfigElement):
    def __init__(self, parent: ConfigNamespace, name: str, description: str,
                 datatype: type, default: Any = None,
                 mutability: Mutability = Mutability.LOCAL,
                 verify: Optional[Callable[[Any], bool]] = None):
        super().__init__(parent, name, description)
        self.datatype = datatype
        self.default = default
        self.mutability = mutability
        self._verify = verify
        if default is not None:
            self.validate(default)

    def coerce(self, value: Any) -> Any:
        """Coerce a raw (possibly string) value to the option's datatype."""
        if isinstance(value, self.datatype):
            return value
        if self.datatype is bool:
            if isinstance(value, str):
                low = value.strip().lower()
                if low in ("true", "1", "yes", "on"):
                    return True
                if low in ("false", "0", "no", "off"):
                    return False
            if isinstance(value, int):
                return bool(value)
            raise ValueError(f"cannot coerce {value!r} to bool for option {self.name}")
        if self.datatype in (int, float, str):
            try:
                return self.datatype(value)
            except (TypeError, ValueError) as e:
                raise ValueError(f"cannot coerce {value!r} for option {self.name}: {e}")
        if self.datatype is list and isinstance(value, str):
            return [v.strip() for v in value.split(",") if v.strip()]
        if self.datatype is list and isinstance(value, (tuple, list)):
            return list(value)
        raise ValueError(f"cannot coerce {value!r} ({type(value).__name__}) "
                         f"to {self.datatype.__name__} for option {self.name}")

    def validate(self, value: Any) -> Any:
        value = self.coerce(value)
        if self._verify is not None and not self._verify(value):
            raise ValueError(f"value {value!r} failed verification for option {self.name}")
        return value


# common verifiers (reference: ConfigOption.positiveInt() etc.)
def positive(v) -> bool:
    return v > 0

def non_negative(v) -> bool:
    return v >= 0

def one_of(*allowed):
    def check(v):
        return v in allowed
    return check
