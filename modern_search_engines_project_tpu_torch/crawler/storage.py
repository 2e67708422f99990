"""Crawl persistence: sqlite-backed document store + full state checkpoint.

The reference's L0 is a DuckDB file with seven tables, used both as the
document store and as the crawl-resume checkpoint (databaseManagement.py,
SURVEY.md §5.4).  Here the host-side store is sqlite3 (stdlib, zero-dep,
transactional); the *index* no longer lives in SQL at all — it is built
from this store into array artifacts (index/builder.py).

A copy of the reference package's ``crawler/storage.py`` (SQLite, no
device code).

Tables:
  documents    — urlsDB analog (databaseManagement.py:18-51)
  crawl_state  — one JSON blob per state component (frontier w/ schedules,
                 metadata, domain delays, disallowed urls/domains, error
                 policy state) — the store()/load() checkpoint analog
                 (databaseManagement.py:423-463)
"""

from __future__ import annotations

import json
import sqlite3
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from modern_search_engines_project_tpu_torch.index.builder import Document

_SCHEMA = """
CREATE TABLE IF NOT EXISTS documents (
    id INTEGER PRIMARY KEY,
    url TEXT UNIQUE NOT NULL,
    title TEXT DEFAULT '',
    text TEXT DEFAULT '',
    last_fetch REAL DEFAULT 0,
    incoming INTEGER DEFAULT 0,
    linking_depth INTEGER DEFAULT 0,
    domain_depth INTEGER DEFAULT 0,
    tue_eng_score REAL DEFAULT 0
);
CREATE INDEX IF NOT EXISTS idx_documents_score
    ON documents(tue_eng_score);
CREATE TABLE IF NOT EXISTS crawl_state (
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS error_log (
    id INTEGER PRIMARY KEY,
    url TEXT NOT NULL,
    code INTEGER,
    reason TEXT,
    ts REAL
);
"""


class CrawlStore:
    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    # --- documents ----------------------------------------------------------

    def upsert_documents(self, rows: Iterable[dict]) -> int:
        """Batch insert/update pages (the reference flushes its page cache
        in batches > 1000, databaseManagement.py:351-355)."""
        rows = list(rows)
        with self._lock:
            self._conn.executemany(
                """INSERT INTO documents
                   (url, title, text, last_fetch, incoming, linking_depth,
                    domain_depth, tue_eng_score)
                   VALUES (:url, :title, :text, :last_fetch, :incoming,
                           :linking_depth, :domain_depth, :tue_eng_score)
                   ON CONFLICT(url) DO UPDATE SET
                     title=excluded.title, text=excluded.text,
                     last_fetch=excluded.last_fetch,
                     incoming=excluded.incoming,
                     linking_depth=excluded.linking_depth,
                     domain_depth=excluded.domain_depth,
                     tue_eng_score=excluded.tue_eng_score""",
                [
                    {
                        "url": r["url"],
                        "title": r.get("title", ""),
                        "text": r.get("text", ""),
                        "last_fetch": r.get("last_fetch", 0.0),
                        "incoming": r.get("incoming", 0),
                        "linking_depth": r.get("linking_depth", 0),
                        "domain_depth": r.get("domain_depth", 0),
                        "tue_eng_score": r.get("tue_eng_score", 0.0),
                    }
                    for r in rows
                ],
            )
            self._conn.commit()
        return len(rows)

    def n_documents(self) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM documents"
            ).fetchone()
        return int(n)

    def has_url(self, url: str) -> bool:
        with self._lock:
            row = self._conn.execute(
                "SELECT 1 FROM documents WHERE url=?", (url,)
            ).fetchone()
        return row is not None

    def iter_documents(
        self, min_score: float = 0.0, batch: int = 1000
    ) -> Iterator[Document]:
        """Stream documents for index building (index_all.py input role)."""
        last_id = 0
        while True:
            with self._lock:
                rows = self._conn.execute(
                    """SELECT id, url, title, text FROM documents
                       WHERE id > ? AND tue_eng_score >= ?
                       ORDER BY id LIMIT ?""",
                    (last_id, min_score, batch),
                ).fetchall()
            if not rows:
                return
            for rid, url, title, text in rows:
                last_id = rid
                yield Document(doc_id=rid, url=url, title=title, text=text)

    # --- error storage (errorStorage/strangeUrls analog,
    # databaseManagement.py:126-137) --------------------------------------

    def log_error(self, url: str, code: int, reason: str, ts: float) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO error_log (url, code, reason, ts) "
                "VALUES (?, ?, ?, ?)",
                (url, code, reason, ts),
            )
            self._conn.commit()

    def recent_errors(self, limit: int = 100) -> List[Tuple]:
        with self._lock:
            return self._conn.execute(
                "SELECT url, code, reason, ts FROM error_log "
                "ORDER BY id DESC LIMIT ?",
                (limit,),
            ).fetchall()

    def export_csv(self, path: str, limit: int = 1000) -> int:
        """Dump the most recent documents to CSV (the reference exports
        recent frontier/urlsDB rows at each checkpoint,
        databaseManagement.py:481-501)."""
        import csv

        with self._lock:
            rows = self._conn.execute(
                "SELECT id, url, title, tue_eng_score, last_fetch "
                "FROM documents ORDER BY id DESC LIMIT ?",
                (limit,),
            ).fetchall()
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "url", "title", "tue_eng_score", "last_fetch"])
            w.writerows(rows)
        return len(rows)

    # --- state checkpoint ---------------------------------------------------

    def save_state(self, state: Dict[str, object]) -> None:
        with self._lock:
            self._conn.executemany(
                "INSERT INTO crawl_state (key, value) VALUES (?, ?) "
                "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
                [(k, json.dumps(v)) for k, v in state.items()],
            )
            self._conn.commit()

    def load_state(self) -> Dict[str, object]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM crawl_state"
            ).fetchall()
        return {k: json.loads(v) for k, v in rows}

    def close(self) -> None:
        with self._lock:
            self._conn.close()
