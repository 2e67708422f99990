"""Batch query evaluation: queries.txt in, ranked result file out.

Counterpart of the reference package's ``eval/batch.py``, line for line.
Parity with the reference's batch endpoints (``search_api.py:204-367``):
input lines ``<query_num>\\t<query>``, output lines
``<query_num>\\t<rank>\\t<url>\\t<score>`` — the exact format graded by the
course rules (`Group Project Rules.ipynb` §2-3), which doubles as our
golden end-to-end harness (SURVEY.md §4).

Where the reference fires every query as a separate asyncio task hammering
the same single-query HTTP path (search_api.py:301-304), here the whole
query file becomes ONE device batch (reference P3 -> query-batch data
parallelism, SURVEY.md §2 table).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class BatchResult:
    query_num: int
    query: str
    rank: int  # 1-based
    url: str
    score: float

    @property
    def formatted_line(self) -> str:
        return f"{self.query_num}\t{self.rank}\t{self.url}\t{self.score}"


def parse_queries_file(content: str) -> List[Tuple[int, str]]:
    """Parse "num\\tquery" lines; skips blank/malformed lines
    (search_api.py:213-238)."""
    out = []
    for line in content.splitlines():
        line = line.strip()
        if not line:
            continue
        parts = line.split("\t", 1)
        if len(parts) != 2:
            continue
        try:
            num = int(parts[0])
        except ValueError:
            continue
        out.append((num, parts[1].strip()))
    return out


def run_batch(
    engine,
    queries: Sequence[Tuple[int, str]],
    top_k: int = 100,
    batch_size: Optional[int] = None,
) -> List[BatchResult]:
    """Run all queries as device batches; returns flat ranked rows."""
    batch_size = batch_size or engine.cfg.query_batch_size
    results: List[BatchResult] = []
    texts = [q for _, q in queries]
    nums = [n for n, _ in queries]
    for i in range(0, len(texts), batch_size):
        ranked_lists = engine.search_batch(texts[i : i + batch_size], top_k=top_k)
        for j, ranked in enumerate(ranked_lists):
            qn, qt = nums[i + j], texts[i + j]
            for rank, doc in enumerate(ranked, start=1):
                results.append(
                    BatchResult(
                        query_num=qn,
                        query=qt,
                        rank=rank,
                        url=doc.url,
                        score=doc.similarity_score,
                    )
                )
    return results


def write_results_file(results: Sequence[BatchResult], path: str) -> None:
    """batch_search_results.txt format (search_api.py:331-367)."""
    with open(path, "w") as f:
        for r in results:
            f.write(r.formatted_line + "\n")


def run_batch_file(
    engine, queries_path: str, output_path: str, top_k: int = 100
) -> List[BatchResult]:
    with open(queries_path) as f:
        queries = parse_queries_file(f.read())
    results = run_batch(engine, queries, top_k=top_k)
    write_results_file(results, output_path)
    return results
