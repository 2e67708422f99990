"""Stage timing + profiling hooks (SURVEY.md §5.1).

The reference wraps every pipeline stage in ad-hoc ``time.time()`` deltas
logged at INFO (search_api.py:44-147, indexer.py:37-133).  The mechanism
preserved here: every stage reports wall time at INFO.  (A device-trace
context on ``torch.profiler`` is later work.)
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterator, Optional

log = logging.getLogger("timing")


class StageTimes:
    """Accumulates per-stage wall times; queryable for observability."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def record(self, stage: str, seconds: float) -> None:
        self.totals[stage] = self.totals.get(stage, 0.0) + seconds
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def report(self) -> Dict[str, dict]:
        return {
            s: {
                "total_s": round(t, 4),
                "count": self.counts[s],
                "mean_ms": round(1000 * t / max(self.counts[s], 1), 3),
            }
            for s, t in sorted(self.totals.items())
        }


GLOBAL_TIMES = StageTimes()


@contextlib.contextmanager
def stage_timer(
    stage: str,
    times: Optional[StageTimes] = None,
    level: int = logging.INFO,
) -> Iterator[None]:
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        (times or GLOBAL_TIMES).record(stage, dt)
        log.log(level, "%s in %.3f s", stage, dt)
