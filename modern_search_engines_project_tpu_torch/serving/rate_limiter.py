"""Sliding-window request rate limiter (reference C8 RateLimiter,
reranker_api.py:68-95).

Counterpart of the reference package's ``serving/rate_limiter.py``.
Disabled by default, like the reference's config.yaml (no enabled flag
set).  Async-safe via an ``asyncio.Lock``; the window prunes timestamps
older than 60 s.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Deque, Optional


class RateLimiter:
    def __init__(self, requests_per_minute: int = 60, enabled: bool = True):
        self.rpm = requests_per_minute
        self.enabled = enabled
        self._times: Deque[float] = deque()
        self._lock = asyncio.Lock()

    async def acquire(self, now: Optional[float] = None) -> bool:
        """True if the request is admitted."""
        if not self.enabled:
            return True
        now = time.time() if now is None else now
        async with self._lock:
            cutoff = now - 60.0
            while self._times and self._times[0] <= cutoff:
                self._times.popleft()
            if len(self._times) >= self.rpm:
                return False
            self._times.append(now)
            return True

    def status(self, now: Optional[float] = None) -> dict:
        """Utilization report (reference /rate-limit-status,
        reranker_api.py:484-516)."""
        now = time.time() if now is None else now
        cutoff = now - 60.0
        current = sum(1 for t in self._times if t > cutoff)
        return {
            "enabled": self.enabled,
            "requests_per_minute": self.rpm,
            "current_usage": current,
            "utilization": current / self.rpm if self.rpm else 0.0,
        }
