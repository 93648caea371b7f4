"""Query predicates.

(reference: titan-core core/attribute/Cmp.java, Text.java, Contain.java —
comparison, text-search and containment predicates usable in ``has()``
conditions and index queries.)

The port's copy of ``titan_tpu/query/predicates.py``.
"""

from __future__ import annotations

import re
from typing import Any, Callable


class P:
    """A typed predicate: ``P.eq(5)``, ``P.gt(3)``, ``P.text_contains("x")``."""

    def __init__(self, op: str, value: Any, test: Callable[[Any], bool]):
        self.op = op
        self.value = value
        self._test = test

    def __call__(self, candidate: Any) -> bool:
        try:
            return self._test(candidate)
        except TypeError:
            return False

    def __repr__(self):
        return f"P.{self.op}({self.value!r})"

    # -- comparison (Cmp) ---------------------------------------------------

    @staticmethod
    def eq(v):
        return P("eq", v, lambda c: c == v)

    @staticmethod
    def neq(v):
        return P("neq", v, lambda c: c != v)

    @staticmethod
    def lt(v):
        return P("lt", v, lambda c: c < v)

    @staticmethod
    def lte(v):
        return P("lte", v, lambda c: c <= v)

    @staticmethod
    def gt(v):
        return P("gt", v, lambda c: c > v)

    @staticmethod
    def gte(v):
        return P("gte", v, lambda c: c >= v)

    @staticmethod
    def between(lo, hi):
        """[lo, hi) interval (reference: Cmp interval semantics)."""
        return P("between", (lo, hi), lambda c: lo <= c < hi)

    @staticmethod
    def inside(lo, hi):
        return P("inside", (lo, hi), lambda c: lo < c < hi)

    # -- containment (Contain) ----------------------------------------------

    @staticmethod
    def within(*values):
        vs = set(values[0]) if len(values) == 1 and \
            isinstance(values[0], (list, set, tuple)) else set(values)
        return P("within", vs, lambda c: c in vs)

    @staticmethod
    def without(*values):
        vs = set(values[0]) if len(values) == 1 and \
            isinstance(values[0], (list, set, tuple)) else set(values)
        return P("without", vs, lambda c: c not in vs)

    # -- text (Text) ---------------------------------------------------------

    @staticmethod
    def text_contains(query: str):
        # reference Text.CONTAINS: the value must contain ALL terms of the
        # (tokenized) query; a token-less query matches nothing
        toks = [t for t in re.split(r"\W+", query.lower()) if t]

        def _test(c, _toks=toks):
            if not _toks:
                return False
            words = set(re.split(r"\W+", str(c).lower()))
            return all(t in words for t in _toks)

        return P("textContains", query, _test)

    @staticmethod
    def text_prefix(prefix: str):
        return P("textPrefix", prefix,
                 lambda c: any(w.startswith(prefix.lower())
                               for w in re.split(r"\W+", str(c).lower())))

    @staticmethod
    def text_regex(pattern: str):
        rx = re.compile(pattern)
        return P("textRegex", pattern,
                 lambda c: any(rx.fullmatch(w)
                               for w in re.split(r"\W+", str(c))))

    @staticmethod
    def string_prefix(prefix: str):
        return P("stringPrefix", prefix, lambda c: str(c).startswith(prefix))

    @staticmethod
    def string_regex(pattern: str):
        rx = re.compile(pattern)
        return P("stringRegex", pattern,
                 lambda c: rx.fullmatch(str(c)) is not None)

    # -- geo (reference: core/attribute/Geo.java) ----------------------------

    @staticmethod
    def geo_within(shape):
        return P("geoWithin", shape, lambda c: c.within(shape))

    @staticmethod
    def geo_intersect(shape):
        return P("geoIntersect", shape, lambda c: c.intersect(shape))

    @staticmethod
    def geo_disjoint(shape):
        return P("geoDisjoint", shape, lambda c: c.disjoint(shape))

    @staticmethod
    def geo_contains(shape):
        return P("geoContains", shape, lambda c: shape.within(c))
