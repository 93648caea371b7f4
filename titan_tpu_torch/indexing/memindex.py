"""MemoryIndex: the in-process mixed-index provider (the Lucene analog).

(reference: titan-lucene LuceneIndex.java — an embedded, single-machine
full-text/numeric/geo index; here: inverted token maps + per-field doc maps
with an optional directory snapshot for durability. Like the reference's
Lucene adapter it is the default local provider the test suites run against;
distributed providers plug in through the same IndexProvider SPI.)
"""

from __future__ import annotations

import os
import pickle
import re
import threading
import tempfile
from typing import Optional

from titan_tpu_torch.core.attribute import Geoshape
from titan_tpu_torch.indexing.provider import (IndexFeatures, IndexMutation,
                                               IndexProvider, IndexQuery,
                                               KeyInformation, RawQuery,
                                               load_pickle)

_TOKEN = re.compile(r"\w+")


def _tokens(text: str) -> list[str]:
    return _TOKEN.findall(str(text).lower())


class _Store:
    __slots__ = ("docs", "keyinfo", "tokens")

    def __init__(self):
        self.docs: dict[str, dict] = {}          # docid -> {field: value}
        self.keyinfo: dict[str, KeyInformation] = {}
        # field -> token -> set(docid), maintained for TEXT-mapped strings
        self.tokens: dict[str, dict[str, set]] = {}


class MemoryIndex(IndexProvider):
    def __init__(self, name: str = "search", directory: Optional[str] = None):
        self.name = name
        self.directory = directory
        self._stores: dict[str, _Store] = {}
        self._lock = threading.RLock()
        self._dirty = False
        if directory:
            os.makedirs(directory, exist_ok=True)
            self._load()

    @property
    def features(self) -> IndexFeatures:
        return IndexFeatures(supports_text=True, supports_geo=True,
                             supports_numeric_range=True, supports_order=True,
                             supports_raw_query=True)

    # -- registration / mutation ---------------------------------------------

    def register(self, store: str, key: str, info: KeyInformation) -> None:
        with self._lock:
            self._stores.setdefault(store, _Store()).keyinfo[key] = info
            self._dirty = True

    def _text_mapped(self, st: _Store, field: str, value) -> bool:
        if not isinstance(value, str):
            return False
        info = st.keyinfo.get(field)
        if info is None:
            return True                       # strings default to TEXT
        return "STRING" not in info.parameters

    def _untoken(self, st: _Store, docid: str, field: str) -> None:
        old = st.docs.get(docid, {}).get(field)
        if old is None:
            return
        for v in old if isinstance(old, list) else [old]:
            if self._text_mapped(st, field, v):
                for t in _tokens(v):
                    st.tokens.get(field, {}).get(t, set()).discard(docid)

    def _token(self, st: _Store, docid: str, field: str, value) -> None:
        for v in value if isinstance(value, list) else [value]:
            if self._text_mapped(st, field, v):
                for t in _tokens(v):
                    st.tokens.setdefault(field, {}).setdefault(
                        t, set()).add(docid)

    def mutate(self, mutations: dict[str, dict[str, IndexMutation]]) -> None:
        with self._lock:
            for store, per_doc in mutations.items():
                st = self._stores.setdefault(store, _Store())
                for docid, m in per_doc.items():
                    if m.deleted:
                        for field in list(st.docs.get(docid, {})):
                            self._untoken(st, docid, field)
                        st.docs.pop(docid, None)
                        continue
                    doc = st.docs.setdefault(docid, {})
                    for field in m.deletions:
                        self._untoken(st, docid, field)
                        doc.pop(field, None)
                    for field, value in m.additions.items():
                        self._untoken(st, docid, field)
                        doc[field] = value
                        self._token(st, docid, field, value)
                    if not doc:
                        st.docs.pop(docid, None)
            # durability is deferred to flush()/close() — snapshotting the
            # whole index per mutation would make commit cost O(index size)
            self._dirty = True

    # -- queries -------------------------------------------------------------

    def query(self, store: str, query: IndexQuery) -> list[str]:
        with self._lock:
            st = self._stores.get(store)
            if st is None:
                return []
            candidates = self._candidates(st, query.condition)
            if candidates is None:
                candidates = list(st.docs)
            hits = [d for d in candidates
                    if d in st.docs and query.condition.evaluate(st.docs[d])]
            for field, direction in reversed(query.orders):
                hits.sort(key=lambda d: (st.docs[d].get(field) is None,
                                         st.docs[d].get(field)),
                          reverse=(direction == "desc"))
            if not query.orders:
                hits.sort()
            if query.limit is not None:
                hits = hits[:query.limit]
            return hits

    def _candidates(self, st: _Store, cond) -> Optional[list]:
        """Token-accelerated candidate narrowing for textContains conjuncts;
        None = no narrowing possible (scan all docs)."""
        from titan_tpu_torch.indexing.provider import And, FieldCondition
        conjuncts = cond.children if isinstance(cond, And) else (cond,)
        best: Optional[set] = None
        for c in conjuncts:
            if isinstance(c, FieldCondition) and c.predicate.op == "textContains":
                toks = _tokens(c.predicate.value)
                for t in toks:
                    s = st.tokens.get(c.field, {}).get(t, set())
                    best = set(s) if best is None else best & s
        return None if best is None else sorted(best)

    def raw_query(self, store: str, query: RawQuery) -> list:
        """Native syntax: ``field:token`` terms, whitespace = AND.
        (reference: LuceneIndex raw query parsing)"""
        with self._lock:
            st = self._stores.get(store)
            if st is None:
                return []
            result: Optional[set] = None
            for term in query.query.split():
                if ":" in term:
                    field, tok = term.split(":", 1)
                else:
                    field, tok = None, term
                tok = tok.lower()
                matches = set()
                if field is not None:
                    matches = st.tokens.get(field, {}).get(tok, set())
                else:
                    for fmap in st.tokens.values():
                        matches |= fmap.get(tok, set())
                result = matches if result is None else result & matches
            hits = sorted(result or ())
            if query.offset:
                hits = hits[query.offset:]
            if query.limit is not None:
                hits = hits[:query.limit]
            return [(d, 1.0) for d in hits]

    def count(self, store: str) -> int:
        with self._lock:
            st = self._stores.get(store)
            return len(st.docs) if st else 0

    # -- durability ----------------------------------------------------------

    def _path(self) -> str:
        return os.path.join(self.directory, f"{self.name}.idx")

    def _snapshot(self) -> None:
        data = {s: (st.docs, st.tokens, st.keyinfo)
                for s, st in self._stores.items()}
        fd, tmp = tempfile.mkstemp(dir=self.directory)
        with os.fdopen(fd, "wb") as f:
            pickle.dump(data, f)
        os.replace(tmp, self._path())

    def _load(self) -> None:
        try:
            with open(self._path(), "rb") as f:
                data = load_pickle(f)
        except FileNotFoundError:
            return
        for s, (docs, tokens, keyinfo) in data.items():
            st = _Store()
            st.docs, st.tokens, st.keyinfo = docs, tokens, keyinfo
            self._stores[s] = st

    def close(self) -> None:
        self.flush()

    def flush(self) -> None:
        with self._lock:
            if self.directory and self._dirty:
                self._snapshot()
                self._dirty = False

    def drop_store(self, store: str) -> None:
        with self._lock:
            self._stores.pop(store, None)
            if self.directory:
                self._snapshot()
                self._dirty = False

    def clear_storage(self) -> None:
        with self._lock:
            self._stores.clear()
            if self.directory:
                try:
                    os.remove(self._path())
                except FileNotFoundError:
                    pass
