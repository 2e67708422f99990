"""What decides ``correct``: served replies against the reference.

A sample of the window's requests, drawn from the seed, is judged once
the window has closed and the program is freed.  Near ties may fall
either way (``reference.Stage2``), so a served row is judged against the
reference scenario that suits it best.  The numbers compared:

  * ``doc_gap`` (stage 2 served): for each served row, the gap between
    its score and the reference's value of the served window, or by how
    much that window falls short of its document's best, whichever is
    wider; 1 for a document that is no candidate (nor near one) or a
    window not its own, or a domain served twice where the reference's
    answer serves each once.  Served scores must not rise down the list.
  * ``miss_gap`` (stage 2 served): for each document of the reference's
    answer that was not served, by how much its least score lies above
    the served score of its domain's document, or above the last served
    score where its domain was not served.
  * ``ce_gap`` (stage 3 served): the widest gap between a served score
    and the reference cross-encoder's score of the query and the served
    window's text, or by which the served order rises.
  * ``stage2_gap`` (stage 3 served): ``doc_gap`` and ``miss_gap`` of the
    stage-2 values under the rows the program rescored: how far a served
    window lies below the reference's last answer score or its
    document's best, and how far an unserved answer document lies above
    the reference's last answer score; 1 for a domain served twice or
    another count of rows than the reference's.

Counts, each with the limit 0: ``sample_failed``, sampled requests that
failed or never got a reply; ``judged_short``, how many fewer replies were
judged than the sample asks for (of the requests sent); and
``bank_dtype_off``, the program's dense banks in another type than the
configuration states (``corpus.bank_dtype``), so a lower-precision bank
switched on by default reads not correct however close its scores lie.
A run is correct where every number and count is within its limit
(``verdict``), the controls of ``benchmark/control.py`` included.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Tuple

import numpy as np

from benchmark.corpus import DOC_ID_BASE

_WINDOW = re.compile(r"w(\d+) ")


def checks(numbers: Dict[str, float], limits: Dict[str, float],
           counts: Dict[str, int] = None) -> Dict[str, Dict]:
    """Each number compared beside its limit, and each count beside 0."""
    out = {k: {"value": float(v), "limit": limits[k]}
           for k, v in numbers.items()}
    for k, v in (counts or {}).items():
        out[k] = {"value": int(v), "limit": 0}
    return out


def verdict(checks: Dict[str, Dict]) -> bool:
    """Whether every number and count is within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def served_rows(body: str) -> List[Tuple[int, int, float]]:
    """(doc, window, score) of each served document, in served order."""
    out = []
    for d in json.loads(body)["documents"]:
        m = _WINDOW.match(d["snippet"])
        out.append((int(d["doc_id"]) - DOC_ID_BASE,
                    int(m.group(1)) if m else -1, float(d["score"])))
    return out


def _row_gap(ref, doc, win, score=None, floor=None) -> float:
    """The least, over the reference's scenarios, of how far a served row
    is from them: its score against the window's value (when ``score`` is
    given), the window's value below its document's best, and the value
    below ``floor``."""
    sc = ref.scenarios(doc)
    k = ref.slot(doc, win)
    if sc is None or k is None:
        return 1.0
    gaps = []
    for v, best in sc:
        g = best - v[k]
        if score is not None:
            g = max(g, abs(score - v[k]))
        if floor is not None:
            g = max(g, floor - v[k])
        gaps.append(g)
    return max(0.0, min(gaps))


def _miss_gap(ref, served_docs, domains, above) -> float:
    """How far an unserved answer document's least score lies above
    ``above(domain)``."""
    served = set(served_docs)
    gap = 0.0
    for d in ref.docs.tolist():
        if d in served:
            continue
        lo = min(best for _, best in ref.scenarios(d))
        gap = max(gap, lo - above(domains[d]))
    return gap


def stage2_numbers(rows, ref, domains) -> Dict[str, float]:
    scores = [s for _, _, s in rows]
    doc_gap = max((_row_gap(ref, d, w, s) for d, w, s in rows), default=0.0)
    if len(scores) > 1:
        doc_gap = max(doc_gap, float(np.diff(scores).max()))
    doms = [domains[d] for d, _, _ in rows if 0 <= d < len(domains)]
    if (len(set(doms)) < len(doms)
            and len(set(domains[ref.docs].tolist())) == len(ref.docs)):
        doc_gap = 1.0  # a domain served twice where one each would do
    by_domain = {}
    for d, _, s in rows:
        if 0 <= d < len(domains):
            by_domain.setdefault(domains[d], s)
    last = scores[-1] if len(scores) >= len(ref.docs) else 0.0
    miss = _miss_gap(ref, [d for d, _, _ in rows], domains,
                     lambda dom: by_domain.get(dom, last))
    return {"doc_gap": doc_gap, "miss_gap": miss}


def stage3_numbers(rows, ref, ce_scores, domains) -> Dict[str, float]:
    served = np.array([s for _, _, s in rows], np.float64)
    ce_gap = float(np.abs(served - ce_scores).max()) if len(rows) else 0.0
    if len(served) > 1:
        ce_gap = max(ce_gap, float(np.diff(served).max()))
    doms = [domains[d] for d, _, _ in rows if 0 <= d < len(domains)]
    if len(rows) != len(ref.docs) or len(set(doms)) < len(rows):
        return {"ce_gap": ce_gap, "stage2_gap": 1.0}
    last = float(ref.scores[-1]) if len(ref.scores) else 0.0
    gap = max((_row_gap(ref, d, w, floor=last) for d, w, _ in rows),
              default=0.0)
    served_doms = set(doms)
    miss = _miss_gap(ref, [d for d, _, _ in rows], domains,
                     lambda dom: 1.0 if dom in served_doms else last)
    return {"ce_gap": ce_gap, "stage2_gap": max(gap, miss)}
