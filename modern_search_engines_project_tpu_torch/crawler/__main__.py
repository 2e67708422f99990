"""Crawler CLI (reference ``python crawler/main.py`` analog).

    python -m modern_search_engines_project_tpu_torch.crawler \
        [--db crawl.sqlite] [--max-pages N] [--seeds url1 url2 ...]

Resumable: re-running with the same --db continues from the persisted
frontier checkpoint.  Stop politely with Ctrl-C (state is saved) — the
reference's stdin "stop" thread equivalent.

A copy of the reference package's ``crawler/__main__.py``.
"""

from __future__ import annotations

import argparse
import asyncio
import logging


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--db", default="crawl.sqlite")
    parser.add_argument("--max-pages", type=int, default=None)
    parser.add_argument("--max-batch", type=int, default=100)
    parser.add_argument("--seeds", nargs="*", default=None)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(message)s"
    )
    from modern_search_engines_project_tpu_torch.crawler import Crawler, CrawlStore

    store = CrawlStore(args.db)
    crawler = Crawler(
        store, max_batch=args.max_batch, max_pages=args.max_pages
    )

    async def run():
        try:
            return await crawler.run(args.seeds)
        except asyncio.CancelledError:
            crawler.save()
            raise

    try:
        n = asyncio.run(run())
        logging.info("crawl finished: %d pages stored", n)
    except KeyboardInterrupt:
        crawler.save()
        logging.info("interrupted: state checkpointed, re-run to resume")


if __name__ == "__main__":
    main()
