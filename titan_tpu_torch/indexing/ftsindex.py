"""Persistent full-text mixed-index provider on sqlite FTS5 — the Lucene
analog.

(reference: titan-lucene LuceneIndex.java — an embedded, single-machine
full-text index implementing the IndexProvider SPI; this provider plays the
same role with sqlite FTS5 as the inverted-index engine. Documents also live
as pickled field dicts so the full predicate set — numeric ranges, geo,
STRING-mapped exacts — evaluates exactly like the in-memory provider; FTS
only narrows textContains candidates and powers raw queries with bm25
scoring.)

Layout per index store (two tables, created on first use):
  ``d_<store>``  (docid TEXT PRIMARY KEY, doc BLOB)        — source of truth
  ``f_<store>``  FTS5(docid UNINDEXED, field, txt)         — one row per
                 TEXT-mapped string field value of a doc

Field names are matched as FTS tokens, so exotic names that tokenize into
multiple terms fall back to un-narrowed evaluation (correct, just slower).
"""

from __future__ import annotations

import os
import pickle
import re
import sqlite3
import threading
from typing import Optional

from titan_tpu_torch.indexing.provider import (And, FieldCondition,
                                               IndexFeatures, IndexMutation,
                                               IndexProvider, IndexQuery,
                                               KeyInformation, RawQuery,
                                               load_pickle)

_NAME = re.compile(r"[^A-Za-z0-9_]")
# unicode tokens, matching the predicate layer's \W+ split — FTS5's
# unicode61 tokenizer normalizes both sides, so 'café' queries hit 'café'
# documents
_TOKEN = re.compile(r"\w+", re.UNICODE)


def _t(store: str, prefix: str) -> str:
    return f"{prefix}_{_NAME.sub('_', store)}"


def _fts_escape(token: str) -> str:
    return '"' + token.replace('"', '""') + '"'


class FTSIndex(IndexProvider):
    def __init__(self, name: str = "search", directory: Optional[str] = None):
        self.name = name
        self.directory = directory
        if directory:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, f"{name}.ftsdb")
        else:
            path = ":memory:"
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._lock = threading.RLock()
        self._tables: set[str] = set()
        self._keyinfo: dict[tuple, KeyInformation] = {}
        self._load_keyinfo()

    @property
    def features(self) -> IndexFeatures:
        return IndexFeatures(supports_text=True, supports_geo=True,
                             supports_numeric_range=True, supports_order=True,
                             supports_raw_query=True)

    # -- setup ---------------------------------------------------------------

    def _ensure(self, store: str) -> None:
        d, f = _t(store, "d"), _t(store, "f")
        if d in self._tables:
            return
        self._conn.execute(
            f"CREATE TABLE IF NOT EXISTS {d} "
            f"(docid TEXT PRIMARY KEY, doc BLOB NOT NULL)")
        self._conn.execute(
            f"CREATE VIRTUAL TABLE IF NOT EXISTS {f} "
            f"USING fts5(docid UNINDEXED, field, txt)")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS keyinfo "
            "(store TEXT, key TEXT, info BLOB, PRIMARY KEY (store, key))")
        self._tables.add(d)

    def _load_keyinfo(self) -> None:
        try:
            rows = self._conn.execute(
                "SELECT store, key, info FROM keyinfo").fetchall()
        except sqlite3.OperationalError:
            return
        for store, key, blob in rows:
            self._keyinfo[(store, key)] = load_pickle(blob)

    def register(self, store: str, key: str, info: KeyInformation) -> None:
        with self._lock:
            self._ensure(store)
            self._keyinfo[(store, key)] = info
            self._conn.execute(
                "INSERT OR REPLACE INTO keyinfo(store, key, info) "
                "VALUES (?, ?, ?)", (store, key, pickle.dumps(info)))
            self._conn.commit()

    def _text_mapped(self, store: str, field: str, value) -> bool:
        if not isinstance(value, str):
            return False
        info = self._keyinfo.get((store, field))
        if info is None:
            return True                      # strings default to TEXT
        return "STRING" not in info.parameters

    # -- mutation ------------------------------------------------------------

    def mutate(self, mutations: dict[str, dict[str, IndexMutation]]) -> None:
        with self._lock:
            for store, per_doc in mutations.items():
                self._ensure(store)
                d, f = _t(store, "d"), _t(store, "f")
                for docid, m in per_doc.items():
                    row = self._conn.execute(
                        f"SELECT doc FROM {d} WHERE docid = ?",
                        (docid,)).fetchone()
                    doc = load_pickle(row[0]) if row else {}
                    if m.deleted:
                        doc = {}
                    else:
                        for field in m.deletions:
                            doc.pop(field, None)
                        doc.update(m.additions)
                    self._conn.execute(
                        f"DELETE FROM {f} WHERE docid = ?", (docid,))
                    if not doc:
                        self._conn.execute(
                            f"DELETE FROM {d} WHERE docid = ?", (docid,))
                        continue
                    self._conn.execute(
                        f"INSERT OR REPLACE INTO {d}(docid, doc) "
                        f"VALUES (?, ?)", (docid, pickle.dumps(doc)))
                    rows = []
                    for field, value in doc.items():
                        for v in value if isinstance(value, list) else [value]:
                            if self._text_mapped(store, field, v):
                                rows.append((docid, field, v))
                    if rows:
                        self._conn.executemany(
                            f"INSERT INTO {f}(docid, field, txt) "
                            f"VALUES (?, ?, ?)", rows)
            self._conn.commit()

    # -- queries -------------------------------------------------------------

    def _fts_docids(self, store: str, field: str, text: str) -> set:
        """Doc ids with ALL tokens of ``text`` in ``field`` (one FTS query)."""
        toks = _TOKEN.findall(text.lower())
        if not toks:
            return set()
        f = _t(store, "f")
        match = "field : " + _fts_escape(field) + " AND txt : (" + \
            " AND ".join(_fts_escape(t) for t in toks) + ")"
        try:
            rows = self._conn.execute(
                f"SELECT docid FROM {f} WHERE {f} MATCH ?", (match,)).fetchall()
        except sqlite3.OperationalError:
            return set()
        return {r[0] for r in rows}

    def _candidates(self, store: str, cond) -> Optional[list]:
        """FTS-accelerated narrowing for textContains conjuncts; None = scan."""
        conjuncts = cond.children if isinstance(cond, And) else (cond,)
        best: Optional[set] = None
        for c in conjuncts:
            if isinstance(c, FieldCondition) and \
                    c.predicate.op == "textContains":
                s = self._fts_docids(store, c.field, str(c.predicate.value))
                best = s if best is None else best & s
        return None if best is None else sorted(best)

    def _doc(self, store: str, docid: str) -> Optional[dict]:
        row = self._conn.execute(
            f"SELECT doc FROM {_t(store, 'd')} WHERE docid = ?",
            (docid,)).fetchone()
        return load_pickle(row[0]) if row else None

    def query(self, store: str, query: IndexQuery) -> list[str]:
        with self._lock:
            self._ensure(store)
            d = _t(store, "d")
            candidates = self._candidates(store, query.condition)
            hits = []
            docs: dict[str, dict] = {}
            if candidates is None:
                rows = self._conn.execute(
                    f"SELECT docid, doc FROM {d}").fetchall()
                pairs = [(docid, load_pickle(blob)) for docid, blob in rows]
            else:
                pairs = [(docid, doc) for docid in candidates
                         if (doc := self._doc(store, docid)) is not None]
            for docid, doc in pairs:
                if query.condition.evaluate(doc):
                    hits.append(docid)
                    docs[docid] = doc
            for field, direction in reversed(query.orders):
                hits.sort(key=lambda i: (docs[i].get(field) is None,
                                         docs[i].get(field)),
                          reverse=(direction == "desc"))
            if not query.orders:
                hits.sort()
            if query.limit is not None:
                hits = hits[:query.limit]
            return hits

    def raw_query(self, store: str, query: RawQuery) -> list:
        """``field:token`` terms, whitespace = AND (same native syntax as the
        in-memory provider / reference LuceneIndex); bm25-summed scores."""
        with self._lock:
            self._ensure(store)
            f = _t(store, "f")
            result: Optional[dict[str, float]] = None
            for term in query.query.split():
                if ":" in term:
                    field, tok = term.split(":", 1)
                else:
                    field, tok = None, term
                toks = _TOKEN.findall(tok.lower())
                if not toks:
                    continue
                match = "txt : (" + " AND ".join(
                    _fts_escape(t) for t in toks) + ")"
                if field is not None:
                    match = "field : " + _fts_escape(field) + " AND " + match
                try:
                    rows = self._conn.execute(
                        f"SELECT docid, bm25({f}) FROM {f} WHERE {f} MATCH ?",
                        (match,)).fetchall()
                except sqlite3.OperationalError:
                    rows = []
                scores: dict[str, float] = {}
                for docid, s in rows:
                    # bm25() returns negative-better; flip to positive-better
                    scores[docid] = scores.get(docid, 0.0) + (-float(s))
                result = scores if result is None else \
                    {d_: result[d_] + s for d_, s in scores.items()
                     if d_ in result}
            if not result:
                return []
            hits = sorted(result.items(), key=lambda kv: (-kv[1], kv[0]))
            if query.offset:
                hits = hits[query.offset:]
            if query.limit is not None:
                hits = hits[:query.limit]
            return hits

    def count(self, store: str) -> int:
        with self._lock:
            self._ensure(store)
            return self._conn.execute(
                f"SELECT COUNT(*) FROM {_t(store, 'd')}").fetchone()[0]

    # -- lifecycle -----------------------------------------------------------

    def drop_store(self, store: str) -> None:
        with self._lock:
            self._ensure(store)
            self._conn.execute(f"DELETE FROM {_t(store, 'd')}")
            self._conn.execute(f"DELETE FROM {_t(store, 'f')}")
            self._conn.commit()

    def clear_storage(self) -> None:
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS keyinfo "
                "(store TEXT, key TEXT, info BLOB, PRIMARY KEY (store, key))")
            tables = [r[0] for r in self._conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table' AND "
                "(name LIKE 'd\\_%' ESCAPE '\\')").fetchall()]
            for d in tables:
                self._conn.execute(f"DROP TABLE IF EXISTS {d}")
                self._conn.execute(f"DROP TABLE IF EXISTS f{d[1:]}")
            self._conn.execute("DELETE FROM keyinfo")
            self._conn.commit()
            self._tables.clear()
            self._keyinfo.clear()

    def flush(self) -> None:
        with self._lock:
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            try:
                self._conn.commit()
                self._conn.close()
            except sqlite3.Error:
                pass
