"""Priority frontier: politeness-scheduled URL queue (reference C10).

The reference keeps a ``heapdict {url: scheduled_unix_time}`` plus parallel
metadata dicts (frontierManagement.py:33-49) and scans it for distinct
domains each round (lstAllDifferentDomains :455-483).  That flat design is
O(frontier) per round once the queue is much deeper than the domain count —
measured on the 100k-page loopback crawl (16 domains, ~90k queued urls) it
decayed to ~5 pages/s with the round cost dominated by draining and
re-pushing the whole heap.

Here the frontier is the classic two-level politeness structure (the
Heritrix/"mercator" shape): one lazy min-heap of ``(when, url)`` PER
DOMAIN, plus one min-heap of ``(ready_key, domain)`` where ``ready_key``
is a lower bound on when the domain can next be fetched
(``max(earliest url schedule, domain politeness delay)``).  A crawl round
pops at most ``max_batch`` ready domains — each contributing its earliest
due URL, so the batch is **all distinct domains** by construction
(selection parity with frontierManagement.py:260-277) — in
O(batch * log n) instead of O(frontier).

A copy of the reference package's ``crawler/frontier.py``.
"""

from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Set, Tuple

from modern_search_engines_project_tpu_torch.crawler.helpers import get_domain


class Frontier:
    def __init__(self):
        self.meta: Dict[str, dict] = {}  # url -> {depth info, incoming, ...}
        self.domain_next: Dict[str, float] = {}
        self.disallowed_urls: Set[str] = set()
        self.disallowed_domains: Set[str] = set()
        self.seen: Set[str] = set()
        self.domain_pending: Dict[str, int] = {}  # pending urls per domain
        # two-level queues (see module docstring); url entries are lazily
        # invalidated against meta, domain entries against _dom_key
        self._domq: Dict[str, List[Tuple[float, str]]] = {}
        self._dom_heap: List[Tuple[float, str]] = []
        self._dom_key: Dict[str, float] = {}

    def __len__(self) -> int:
        return len(self.meta)

    def __contains__(self, url: str) -> bool:
        return url in self.meta

    # --- internal queue helpers ----------------------------------------------

    def _dom_push(self, domain: str, key: float) -> None:
        """Ensure the domain is findable in the domain heap no later than
        ``key`` (a lower bound on its readiness)."""
        cur = self._dom_key.get(domain)
        if cur is None or key < cur:
            self._dom_key[domain] = key
            heapq.heappush(self._dom_heap, (key, domain))

    def _dom_head(self, domain: str) -> Optional[Tuple[float, str]]:
        """Earliest valid (when, url) of the domain; pops stale entries."""
        q = self._domq.get(domain)
        while q:
            when, url = q[0]
            m = self.meta.get(url)
            if m is None or m["scheduled"] != when:
                heapq.heappop(q)  # removed or rescheduled
                continue
            return q[0]
        return None

    # --- write --------------------------------------------------------------

    def add(
        self,
        url: str,
        *,
        when: Optional[float] = None,
        incoming_score: float = 0.0,
        linking_depth: int = 0,
        domain_depth: int = 0,
        now: Optional[float] = None,
    ) -> bool:
        """Enqueue url (dedup + disallow checks); True if newly added.

        Re-adding an existing url only bumps its incoming-link evidence
        (frontierWrite dedup semantics, frontierManagement.py:119-171).
        """
        now = time.time() if now is None else now
        domain = get_domain(url)
        if (
            not domain
            or url in self.disallowed_urls
            or domain in self.disallowed_domains
        ):
            return False
        if url in self.meta:
            m = self.meta[url]
            m["incoming"] += 1
            m["incoming_score"] += incoming_score
            m["linking_depth"] = min(m["linking_depth"], linking_depth)
            m["domain_depth"] = min(m["domain_depth"], domain_depth)
            return False
        when = now if when is None else when
        self.meta[url] = {
            "incoming": 1,
            "incoming_score": incoming_score,
            "linking_depth": linking_depth,
            "domain_depth": domain_depth,
            "scheduled": when,
        }
        self.seen.add(url)
        self.domain_pending[domain] = self.domain_pending.get(domain, 0) + 1
        heapq.heappush(self._domq.setdefault(domain, []), (when, url))
        self._dom_push(domain, when)
        return True

    def reschedule(self, url: str, when: float) -> None:
        if url in self.meta:
            self.meta[url]["scheduled"] = when
            domain = get_domain(url)
            heapq.heappush(self._domq.setdefault(domain, []), (when, url))
            self._dom_push(domain, when)

    def _drop(self, url: str) -> Optional[dict]:
        """Remove url from meta, keeping the per-domain pending counts
        exact (queue entries are lazily invalidated)."""
        m = self.meta.pop(url, None)
        if m is not None:
            d = get_domain(url)
            left = self.domain_pending.get(d, 0) - 1
            if left > 0:
                self.domain_pending[d] = left
            else:
                self.domain_pending.pop(d, None)
        return m

    def remove(self, url: str) -> Optional[dict]:
        return self._drop(url)  # queue entries lazily invalidated

    def disallow_url(self, url: str) -> None:
        self.disallowed_urls.add(url)
        self.remove(url)

    def disallow_domain(self, domain: str) -> None:
        """Domain kill switch: drop every queued url of the domain
        (statusCodeManagement.py:311-319 effect)."""
        self.disallowed_domains.add(domain)
        for url in [u for u in self.meta if get_domain(u) == domain]:
            self.remove(url)
        self._domq.pop(domain, None)

    def set_domain_delay(self, domain: str, next_ok: float) -> None:
        self.domain_next[domain] = max(
            self.domain_next.get(domain, 0.0), next_ok
        )

    # --- read ---------------------------------------------------------------

    def pop_due(
        self, max_batch: int = 100, now: Optional[float] = None
    ) -> List[Tuple[str, dict]]:
        """Up to max_batch due urls, all distinct domains; removed from the
        frontier (caller re-adds on retry)."""
        now = time.time() if now is None else now
        batch: List[Tuple[str, dict]] = []
        taken: List[str] = []  # domains that contributed to this batch
        while self._dom_heap and len(batch) < max_batch:
            key, domain = self._dom_heap[0]
            if self._dom_key.get(domain) != key:
                heapq.heappop(self._dom_heap)  # superseded duplicate
                continue
            if key > now:
                break  # keys are readiness lower bounds, heap-ordered
            heapq.heappop(self._dom_heap)
            del self._dom_key[domain]
            if domain in self.disallowed_domains:
                self._domq.pop(domain, None)
                continue
            head = self._dom_head(domain)
            if head is None:
                self._domq.pop(domain, None)  # fully drained/stale
                continue
            hwhen, hurl = head
            ready = max(hwhen, self.domain_next.get(domain, 0.0))
            if ready > now:
                self._dom_push(domain, ready)  # revisit when actually ready
                continue
            heapq.heappop(self._domq[domain])
            m = self._drop(hurl)
            batch.append((hurl, m))
            taken.append(domain)  # re-keyed AFTER the round: distinct rule
        for domain in taken:
            head = self._dom_head(domain)
            if head is None:
                self._domq.pop(domain, None)
            else:
                self._dom_push(
                    domain,
                    max(head[0], self.domain_next.get(domain, 0.0)),
                )
        return batch

    def next_due_time(self) -> Optional[float]:
        """Lower bound on when the next url becomes fetchable (callers
        sleep until then and re-poll)."""
        while self._dom_heap:
            key, domain = self._dom_heap[0]
            if self._dom_key.get(domain) != key:
                heapq.heappop(self._dom_heap)
                continue
            if self._dom_head(domain) is None:
                heapq.heappop(self._dom_heap)
                del self._dom_key[domain]
                self._domq.pop(domain, None)
                continue
            return key
        return None

    # --- checkpoint ---------------------------------------------------------

    def to_state(self) -> dict:
        return {
            "meta": self.meta,
            "domain_next": self.domain_next,
            "disallowed_urls": sorted(self.disallowed_urls),
            "disallowed_domains": sorted(self.disallowed_domains),
            "seen": sorted(self.seen),
        }

    @classmethod
    def from_state(cls, state: dict) -> "Frontier":
        f = cls()
        f.meta = dict(state.get("meta", {}))
        f.domain_next = dict(state.get("domain_next", {}))
        f.disallowed_urls = set(state.get("disallowed_urls", []))
        f.disallowed_domains = set(state.get("disallowed_domains", []))
        f.seen = set(state.get("seen", []))
        for url, m in f.meta.items():
            when = m.get("scheduled", 0.0)
            d = get_domain(url)
            f.domain_pending[d] = f.domain_pending.get(d, 0) + 1
            heapq.heappush(f._domq.setdefault(d, []), (when, url))
            f._dom_push(d, when)
        return f
