"""Frozen term dictionary: analyzed term -> dense int id.

The reference keys every BM25 table by the term *string*
(``indexer/bm25_indexer.py:86-122``).  On TPU the postings matrix is CSR
over dense integer term ids, so the dictionary is built once from the
corpus, frozen, and persisted with the index artifacts; query terms outside
the dictionary simply score nothing (same behavior as the reference's SQL
``WHERE term IN (...)`` returning no rows).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional


class TermDictionary:
    def __init__(self, term_to_id: Optional[Dict[str, int]] = None):
        self.term_to_id: Dict[str, int] = dict(term_to_id or {})

    def __len__(self) -> int:
        return len(self.term_to_id)

    def add(self, term: str) -> int:
        tid = self.term_to_id.get(term)
        if tid is None:
            tid = len(self.term_to_id)
            self.term_to_id[term] = tid
        return tid

    def get(self, term: str) -> int:
        """-1 for out-of-dictionary terms (pad id for the device kernels)."""
        return self.term_to_id.get(term, -1)

    def ids(self, terms: Iterable[str]) -> List[int]:
        return [self.get(t) for t in terms]

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.term_to_id, f)

    @classmethod
    def load(cls, path: str) -> "TermDictionary":
        with open(path) as f:
            return cls(json.load(f))
