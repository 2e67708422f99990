"""Crawler orchestration: frontier loop with politeness, scoring, resume.

The reference's crawl loop (crawler/main.py:63-109 + frontierManagement.py)
re-designed as one async class:

  round := pop <= 100 due urls (distinct domains) -> fetch concurrently ->
  per response: robots check -> status policy (backoff / retry budgets /
  redirect chains / UTEMA domain kill) -> parse html -> tueEngScore ->
  store page -> if score > 0.5 and depths < 5: enqueue outgoing links.

Stop conditions: frontier empty, ``max_pages`` reached, or an external
``stop_event`` (the reference's stdin "stop" thread, crawler/main.py:25-44).
State checkpoints to the CrawlStore on every flush and at shutdown; a new
run resumes exactly where the old one stopped (course requirement,
SURVEY.md §5.4).

A copy of the reference package's ``crawler/main.py``; its default
``Fetcher`` fetches over ``crawler.fetch.AsyncioTransport``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional, Sequence

from modern_search_engines_project_tpu_torch.crawler.fetch import Fetcher, FetchResult
from modern_search_engines_project_tpu_torch.crawler.frontier import Frontier
from modern_search_engines_project_tpu_torch.crawler.helpers import get_domain
from modern_search_engines_project_tpu_torch.crawler.html_parser import parse_html
from modern_search_engines_project_tpu_torch.crawler.metric import tue_eng_score
from modern_search_engines_project_tpu_torch.crawler.robots import RobotsCache
from modern_search_engines_project_tpu_torch.crawler.status_policy import StatusPolicy
from modern_search_engines_project_tpu_torch.crawler.storage import CrawlStore

log = logging.getLogger("crawler")

EXPAND_THRESHOLD = 0.5  # frontierManagement.py:239
MAX_DEPTH = 5
CACHE_FLUSH = 1000  # databaseManagement.py:351-355
DEFAULT_SEEDS = [
    "https://www.tuebingen.de/en/",
    "https://uni-tuebingen.de/en/",
    "https://www.tuebingen-info.de/en/",
    "https://en.wikipedia.org/wiki/T%C3%BCbingen",
    "https://www.my-stuwe.de/en/",
    "https://www.tuebingen.mpg.de/en",
    "https://cyber-valley.de/en/",
    "https://www.medizin.uni-tuebingen.de/en-de/startseite",
    "https://tuebingenresearchcampus.com/",
    "https://www.germany.travel/en/cities-culture/tuebingen.html",
]


class Crawler:
    def __init__(
        self,
        store: CrawlStore,
        fetcher: Optional[Fetcher] = None,
        max_batch: int = 100,
        max_pages: Optional[int] = None,
        stop_event: Optional[asyncio.Event] = None,
        content_filter: bool = True,
        expand_threshold: Optional[float] = None,
    ):
        self.store = store
        self.fetcher = fetcher or Fetcher()
        self.frontier = Frontier()
        self.robots = RobotsCache()
        self.policy = StatusPolicy()
        self.max_batch = max_batch
        self.max_pages = max_pages
        self.stop_event = stop_event or asyncio.Event()
        self.content_filter = content_filter
        # link-expansion gate (reference frontierManagement.py:239); a
        # generic non-Tübingen crawl (tools/real_run.py) passes -1 so
        # every stored page expands regardless of tueEngScore
        self.expand_threshold = (
            EXPAND_THRESHOLD if expand_threshold is None else expand_threshold
        )
        self.page_cache: List[dict] = []
        self.pages_stored = 0
        self.rounds = 0
        self._started = time.time()

    # --- state --------------------------------------------------------------

    def load(self) -> bool:
        state = self.store.load_state()
        if not state:
            return False
        self.frontier = Frontier.from_state(state.get("frontier", {}))
        for dom, text in state.get("robots", {}).items():
            self.robots.update(dom, text)
        self._robots_texts = dict(state.get("robots", {}))
        return True

    def save(self) -> None:
        self.flush_cache()
        self.store.save_state(
            {
                "frontier": self.frontier.to_state(),
                "robots": getattr(self, "_robots_texts", {}),
                "pages_stored": self.pages_stored,
            }
        )

    def flush_cache(self) -> None:
        if self.page_cache:
            self.store.upsert_documents(self.page_cache)
            self.page_cache.clear()

    # --- seeding ------------------------------------------------------------

    def seed(self, urls: Optional[Sequence[str]] = None) -> None:
        for url in urls or DEFAULT_SEEDS:
            self.frontier.add(url)

    # --- one response -------------------------------------------------------

    def _handle_response(self, res: FetchResult, meta: dict) -> None:
        url = res.url
        domain = get_domain(url)
        if res.robots_text is not None:
            self.robots.update(domain, res.robots_text)
            self._robots_texts = getattr(self, "_robots_texts", {})
            self._robots_texts[domain] = res.robots_text
        # Enforce robots unconditionally — URLs enqueued before the domain's
        # robots.txt was known (seeds, early link discovery) must still be
        # dropped once the rules arrive, not parsed and stored.
        if not self.robots.allowed(domain, url):
            self.frontier.disallow_url(url)
            return

        decision = self.policy.record(
            url, res.status, res.retry_after, res.location
        )
        if decision.kill_domain:
            self.frontier.disallow_domain(domain)
            return
        if decision.action == "follow_redirect" and res.location:
            self.frontier.add(
                res.location,
                incoming_score=meta.get("incoming_score", 0.0),
                linking_depth=meta.get("linking_depth", 0),
                domain_depth=meta.get("domain_depth", 0),
            )
            return
        if decision.action == "retry":
            when = time.time() + max(
                decision.delay, self.robots.delay(domain)
            )
            self.frontier.add(url, when=when, **_depths(meta))
            self.frontier.set_domain_delay(domain, when)
            return
        if decision.action == "drop":
            self.store.log_error(
                url, res.status, decision.reason, time.time()
            )
            self.frontier.disallow_url(url)
            return

        # --- 2xx: parse, score, store, expand ---
        if "html" not in (res.content_type or "html"):
            return
        title, text, links = parse_html(res.text, url)
        score = tue_eng_score(
            text,
            url,
            incoming=meta.get("incoming", 1),
            linking_depth=meta.get("linking_depth", 0),
            domain_depth=meta.get("domain_depth", 0),
            incoming_total_score=meta.get("incoming_score", 0.0),
        )
        if not self.content_filter or score > 0.0:
            self.page_cache.append(
                {
                    "url": url,
                    "title": title,
                    "text": text,
                    "last_fetch": time.time(),
                    "incoming": meta.get("incoming", 1),
                    "linking_depth": meta.get("linking_depth", 0),
                    "domain_depth": meta.get("domain_depth", 0),
                    "tue_eng_score": score,
                }
            )
            self.pages_stored += 1
        if len(self.page_cache) >= CACHE_FLUSH:
            self.save()

        ld = meta.get("linking_depth", 0)
        dd = meta.get("domain_depth", 0)
        if score > self.expand_threshold and ld < MAX_DEPTH and dd < MAX_DEPTH:
            for link in links:
                same_domain = get_domain(link) == domain
                if not self.robots.allowed(get_domain(link), link):
                    continue
                if self.store.has_url(link):
                    continue
                self.frontier.add(
                    link,
                    incoming_score=score,
                    linking_depth=ld + 1,
                    domain_depth=dd + (0 if same_domain else 1),
                )
        # politeness: next fetch of this domain after its crawl-delay
        self.frontier.set_domain_delay(
            domain, time.time() + self.robots.delay(domain)
        )

    # --- loop ---------------------------------------------------------------

    async def run(self, seeds: Optional[Sequence[str]] = None) -> int:
        if not self.load():
            self.seed(seeds)
        while len(self.frontier) and not self.stop_event.is_set():
            if self.max_pages and self.pages_stored >= self.max_pages:
                break
            batch = self.frontier.pop_due(self.max_batch)
            if not batch:
                nxt = self.frontier.next_due_time()
                if nxt is None:
                    break
                await asyncio.sleep(min(1.0, max(0.01, nxt - time.time())))
                continue
            results = await self.fetcher.fetch_many([u for u, _ in batch])
            meta_by_url: Dict[str, dict] = dict(batch)
            for res in results:
                self._handle_response(res, meta_by_url.get(res.url, {}))
            self.rounds += 1
            if self.rounds % 10 == 0:
                self._print_stats()
        self.save()
        await self.fetcher.aclose()
        return self.pages_stored

    def _print_stats(self) -> None:
        dt = max(time.time() - self._started, 1e-9)
        log.info(
            "round=%d frontier=%d stored=%d disallowed_urls=%d "
            "disallowed_domains=%d pages/s=%.2f",
            self.rounds,
            len(self.frontier),
            self.pages_stored,
            len(self.frontier.disallowed_urls),
            len(self.frontier.disallowed_domains),
            self.pages_stored / dt,
        )


def _depths(meta: dict) -> dict:
    return {
        "incoming_score": meta.get("incoming_score", 0.0),
        "linking_depth": meta.get("linking_depth", 0),
        "domain_depth": meta.get("domain_depth", 0),
    }


def run_crawler(
    db_path: str = "crawl.sqlite",
    seeds: Optional[Sequence[str]] = None,
    max_pages: Optional[int] = None,
) -> int:
    """Blocking entry point (reference runCrawler, crawler/main.py:114-118)."""
    store = CrawlStore(db_path)
    crawler = Crawler(store, max_pages=max_pages)
    return asyncio.run(crawler.run(seeds))
