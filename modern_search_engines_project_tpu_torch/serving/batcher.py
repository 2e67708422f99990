"""Dynamic online query batching.

Counterpart of the reference package's ``serving/batcher.py``.  Concurrent
online ``/api/search`` requests ride ONE device batch: requests arriving
within a small coalescing window (or until ``max_batch``) are stacked into
a single ``engine.rank_batch`` call on the service's device worker, and the
per-request results are fanned back out after ``engine.finish_batch``,
which runs off the device worker so batch N's finishing overlaps batch
N+1's ranking.  ``rank_batch`` pads the batch to a power of two, so the
set of batch shapes stays bounded.

Single event loop, no locks: mutation happens only on loop callbacks.
"""

from __future__ import annotations

import asyncio
from typing import List, Optional, Tuple


class QueryBatcher:
    """Coalesce concurrent search requests into one device batch."""

    def __init__(
        self,
        engine,
        pool,
        max_batch: int = 64,
        window_ms: float = 3.0,
        finish_pool=None,
    ):
        self.engine = engine
        self._pool = pool  # the service's single device-worker executor
        # host finishing (dedup, diversification, RankedDoc rows) runs OFF
        # the device worker (the loop's default executor when None)
        self._finish_pool = finish_pool
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self._pending: List[Tuple[str, int, asyncio.Future]] = []
        self._timer: Optional[asyncio.TimerHandle] = None
        # observability (exposed via /api/timings)
        self.requests = 0
        self.device_batches = 0
        self.largest_batch = 0

    async def search(self, query: str, top_k: int):
        """Await the ranked list for one query; batching is transparent."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((query, top_k, fut))
        self.requests += 1
        if len(self._pending) >= self.max_batch:
            self._flush()
        elif self._timer is None:
            self._timer = loop.call_later(self.window_s, self._flush)
        return await fut

    def _flush(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self._pending:
            return
        batch = self._pending[: self.max_batch]
        del self._pending[: len(batch)]
        self.device_batches += 1
        self.largest_batch = max(self.largest_batch, len(batch))
        loop = asyncio.get_running_loop()

        async def run():
            texts = [q for q, _, _ in batch]
            k = max(t for _, t, _ in batch)
            engine = self.engine  # pin: /api/reload may swap mid-flight
            try:
                raw = await loop.run_in_executor(
                    self._pool,
                    lambda: engine.rank_batch(texts),
                )
                results = await loop.run_in_executor(
                    self._finish_pool,
                    lambda: engine.finish_batch(raw, texts, top_k=k),
                )
            except Exception as exc:  # fan the failure out per request
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)
                return
            for (_, tk, fut), ranked in zip(batch, results):
                if not fut.done():
                    fut.set_result(ranked[:tk])

        asyncio.ensure_future(run())
        if self._pending:  # overflow past max_batch: flush again right away
            loop.call_soon(self._flush)

    def stats(self) -> dict:
        return {
            "requests": self.requests,
            "device_batches": self.device_batches,
            "largest_batch": self.largest_batch,
            "coalescing_ratio": (
                round(self.requests / self.device_batches, 2)
                if self.device_batches
                else 0.0
            ),
        }
