"""Stage timing + profiling hooks (SURVEY.md §5.1).

The reference wraps every pipeline stage in ad-hoc ``time.time()`` deltas
logged at INFO (search_api.py:44-147, indexer.py:37-133).  The mechanism
preserved here: every stage reports wall time at INFO, plus an optional
``torch.profiler`` trace context for real device profiling.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Dict, Iterator, Optional

log = logging.getLogger("timing")


class StageTimes:
    """Accumulates per-stage wall times; queryable for observability.
    Safe to record from several threads at once (the data plane runs two
    batches through one engine)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.totals[stage] = self.totals.get(stage, 0.0) + seconds
            self.counts[stage] = self.counts.get(stage, 0) + 1

    def report(self) -> Dict[str, dict]:
        with self._lock:
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


@contextlib.contextmanager
def device_trace(out_dir: Optional[str] = None, device=None) -> Iterator[None]:
    """``torch.profiler`` trace context (no-op when ``out_dir`` is None).

    Records host (CPU) activity always, and CUDA activity when ``device``
    (the engine's) is a card; on exit the Chrome trace is written to
    ``out_dir/trace_<pid>_<ns>.json``."""
    if out_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    on_card = device is not None and torch.device(device).type == "cuda"
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if on_card:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(
        os.path.join(out_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )
