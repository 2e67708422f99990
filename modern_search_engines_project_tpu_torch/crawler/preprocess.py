"""Multi-session crawl merge + cleanup (reference C4, preprocessor.ipynb).

The reference notebook merges a new crawl DB into a historical one with:
URL normalization (strip protocol/query/trailing slash, cell 5), two-phase
dedup (drop URLs already in the historical set, then in-batch dedup,
cell 7), a dual language-detection gate (cells 11-14; here the
self-contained English detector from crawler/metric.py), and sequential
re-IDs from max_id+1 (cell 16).  Re-designed as a library function over
CrawlStores instead of notebook cells.

A copy of the reference package's ``crawler/preprocess.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

from modern_search_engines_project_tpu_torch.crawler.helpers import normalize_url
from modern_search_engines_project_tpu_torch.crawler.metric import (
    english_score,
    trigram_english_score,
)
from modern_search_engines_project_tpu_torch.crawler.storage import CrawlStore


@dataclasses.dataclass
class MergeReport:
    incoming: int = 0
    dropped_duplicate_historical: int = 0
    dropped_duplicate_batch: int = 0
    dropped_language: int = 0
    merged: int = 0


def merge_crawls(
    historical: CrawlStore,
    incoming: CrawlStore,
    english_threshold: float = 0.15,
    trigram_threshold: float = 0.5,
    min_text_chars: int = 50,
) -> MergeReport:
    """Merge ``incoming`` documents into ``historical``.

    Dedup is by normalized URL; language gate keeps documents passing
    EITHER of two independent detectors (stopword-ratio OR character
    trigrams) — the reference accepts a page if langdetect says 'en' OR
    polyglot confidence >= 0.15 (cells 11-14), i.e. a deliberately
    permissive dual-signal bar; callers can raise the threshold.
    """
    report = MergeReport()
    seen: Set[str] = set()
    for doc in historical.iter_documents(min_score=-1.0):
        seen.add(normalize_url(doc.url))

    batch: List[dict] = []
    batch_seen: Set[str] = set()
    for doc in incoming.iter_documents(min_score=-1.0):
        report.incoming += 1
        key = normalize_url(doc.url)
        if key in seen:
            report.dropped_duplicate_historical += 1
            continue
        if key in batch_seen:
            report.dropped_duplicate_batch += 1
            continue
        if (
            len(doc.text) >= min_text_chars
            and english_score(doc.text, inconclusive=0.0) < english_threshold
            and trigram_english_score(doc.text) < trigram_threshold
        ):
            report.dropped_language += 1
            continue
        batch_seen.add(key)
        batch.append(
            {
                "url": doc.url,
                "title": doc.title,
                "text": doc.text,
            }
        )
    if batch:
        historical.upsert_documents(batch)
    report.merged = len(batch)
    return report
