"""Persistent, searchable inverted index (sqlite-backed).

Reference parity: ``text/invertedindex/LuceneInvertedIndex.java``
(~927 LoC) — a disk-persistent index of tokenized documents with
per-word posting lists, document reconstruction, label storage, and
batched writes, used as the backing store for bag-of-words vectorizers
and sampled document iteration.  Lucene is replaced by sqlite (stdlib):
the capability contract — persistence across reloads, word→documents
lookup, ranked search — is the parity target, not the Lucene API.

Drop-in superset of the in-memory ``vectorizers.InvertedIndex`` surface
(``add_document`` / ``documents_containing`` / ``doc_frequency`` /
``num_docs``), plus TF-IDF ranked ``search`` and document/label
round-trips.  Safe for concurrent readers; one writer at a time (sqlite
semantics).

Port of ``deeplearning4j_tpu/nlp/inverted_index.py``: a copy (sqlite3 from the standard library).
"""

from __future__ import annotations

import json
import math
import sqlite3
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

_SCHEMA = """
CREATE TABLE IF NOT EXISTS docs (
    id INTEGER PRIMARY KEY,
    tokens TEXT NOT NULL,
    label TEXT
);
CREATE TABLE IF NOT EXISTS postings (
    term TEXT NOT NULL,
    doc_id INTEGER NOT NULL,
    freq INTEGER NOT NULL,
    PRIMARY KEY (term, doc_id)
) WITHOUT ROWID;
CREATE INDEX IF NOT EXISTS postings_by_doc ON postings (doc_id);
"""


class SqliteInvertedIndex:
    """word → posting lists in a sqlite file (``":memory:"`` for tests).

    The index survives close/reopen on the same path — the persistence
    the reference gets from its Lucene directory.
    """

    def __init__(self, path: str = ":memory:"):
        self.path = path
        # one connection guarded by a lock: callers may index from a
        # producer thread while another thread searches
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    # -- writing ------------------------------------------------------------
    def _insert_locked(self, tokens: Sequence[str], label: Optional[str],
                       doc_id: Optional[int]) -> int:
        counts: Dict[str, int] = {}
        for t in tokens:
            counts[t] = counts.get(t, 0) + 1
        cur = self._conn.execute(
            "INSERT INTO docs (id, tokens, label) VALUES (?, ?, ?)",
            (doc_id, json.dumps(list(tokens)), label))
        new_id = cur.lastrowid
        self._conn.executemany(
            "INSERT OR REPLACE INTO postings (term, doc_id, freq) "
            "VALUES (?, ?, ?)",
            [(t, new_id, c) for t, c in counts.items()])
        return int(new_id)

    def add_document(self, tokens: Sequence[str],
                     label: Optional[str] = None,
                     doc_id: Optional[int] = None) -> int:
        """Index one document; returns its id (LuceneInvertedIndex
        ``addWordsToDoc`` parity, with the label-aware variant folded
        in)."""
        with self._lock:
            try:
                new_id = self._insert_locked(tokens, label, doc_id)
                self._conn.commit()
            except Exception:
                # never leave a partial insert pending on the shared
                # connection: the next unrelated commit would persist it
                self._conn.rollback()
                raise
        return new_id

    def add_documents(self, docs: Sequence[Tuple[Sequence[str],
                                                 Optional[str]]]) -> List[int]:
        """Batched variant (the reference buffers into miniBatches): ONE
        transaction/fsync for the whole batch, not one per document."""
        with self._lock:
            try:
                ids = [self._insert_locked(tokens, label, None)
                       for tokens, label in docs]
                self._conn.commit()
            except Exception:
                self._conn.rollback()     # all-or-nothing for the batch
                raise
        return ids

    # -- reading ------------------------------------------------------------
    def document(self, doc_id: int) -> Tuple[List[str], Optional[str]]:
        """(tokens, label) round-trip (``document(index)`` parity)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT tokens, label FROM docs WHERE id = ?",
                (doc_id,)).fetchone()
        if row is None:
            raise KeyError(f"no document {doc_id}")
        return json.loads(row[0]), row[1]

    def documents_containing(self, word: str) -> List[int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT doc_id FROM postings WHERE term = ? ORDER BY doc_id",
                (word,)).fetchall()
        return [r[0] for r in rows]

    def doc_frequency(self, word: str) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM postings WHERE term = ?",
                (word,)).fetchone()
        return int(n)

    def term_frequency(self, word: str) -> int:
        """Total occurrences across the corpus."""
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COALESCE(SUM(freq), 0) FROM postings "
                "WHERE term = ?", (word,)).fetchone()
        return int(n)

    def num_docs(self) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM docs").fetchone()
        return int(n)

    def doc_ids(self) -> List[int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id FROM docs ORDER BY id").fetchall()
        return [r[0] for r in rows]

    def iter_documents(self) -> Iterator[Tuple[int, List[str],
                                               Optional[str]]]:
        """(id, tokens, label) over the whole corpus (``eachDoc``
        parity)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, tokens, label FROM docs ORDER BY id").fetchall()
        for doc_id, tokens, label in rows:
            yield doc_id, json.loads(tokens), label

    def vocab(self) -> List[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT term FROM postings ORDER BY term").fetchall()
        return [r[0] for r in rows]

    # -- search -------------------------------------------------------------
    def search(self, query: Sequence[str],
               top_n: int = 10) -> List[Tuple[int, float]]:
        """TF-IDF ranked document search over the query terms — the
        retrieval capability the reference gets from Lucene scoring.
        Returns [(doc_id, score)] best-first."""
        if isinstance(query, str):
            query = query.split()
        n_docs = self.num_docs()
        if n_docs == 0:
            return []
        scores: Dict[int, float] = {}
        for term in query:
            df = self.doc_frequency(term)
            if df == 0:
                continue
            idf = math.log((1 + n_docs) / (1 + df)) + 1.0
            with self._lock:
                rows = self._conn.execute(
                    "SELECT doc_id, freq FROM postings WHERE term = ?",
                    (term,)).fetchall()
            for doc_id, freq in rows:
                scores[doc_id] = scores.get(doc_id, 0.0) + freq * idf
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        return ranked[:top_n]

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def __enter__(self) -> "SqliteInvertedIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
