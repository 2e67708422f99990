"""Stage timing + profiling hooks (SURVEY.md §5.1).

The reference wraps every pipeline stage in ad-hoc ``time.time()`` deltas
logged at INFO (search_api.py:44-147, indexer.py:37-133).  Here every
stage is a span on ``StageTimes``, the engine's one registry of spans and
counters: wall time on the monotonic clock (CLOCK_MONOTONIC on Linux, the
clock of the C++ data plane's ``steady_clock`` and of ``time.monotonic()``)
and the thread's CPU time inside the span, logged at DEBUG; plus an
optional ``torch.profiler`` trace context for real device profiling.

Wall minus CPU is the time the thread was off the CPU: blocked, preempted
or asleep waiting for a lock.  Where a kernel lets a thread spin for the
interpreter lock instead of sleeping, that wait reads as CPU time.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Tuple

log = logging.getLogger("timing")

_local = threading.local()  # per thread: its open spans, (name, registry)


def _open_spans() -> List[tuple]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class StageTimes:
    """The engine's spans and counters; queryable for observability.
    Safe to record from several threads at once (the data plane runs two
    batches through one engine).

    A span stage (``stage_timer``) sums its wall time, its calls and the
    thread's CPU time.  A counter (``record``) sums seconds over calls.
    ``add_source`` names a function whose (seconds, count) pairs are read
    at each ``report`` (the data plane's counters live in C++).

    ``keep_spans(capacity)`` switches on a record of the newest
    ``capacity`` spans: ``(name, parent, thread ident, batch id, t0_ns,
    t1_ns)`` on the monotonic clock; off (the default), a span allocates
    nothing for it."""

    def __init__(self) -> None:
        # stage -> [wall_ns, count, cpu_ns]; counters keep cpu_ns None
        self._stats: Dict[str, list] = {}
        self._sources: Dict[str, Callable[[], Dict[str, Tuple[float, int]]]] = {}
        self._spans: Optional[deque] = None
        self._batches = 0
        self._batch = threading.local()  # per thread: its current batch id
        self._lock = threading.Lock()

    def record(self, stage: str, seconds: float) -> None:
        """Add one call that took ``seconds`` to counter ``stage``."""
        with self._lock:
            s = self._stats.setdefault(stage, [0, 0, None])
            s[0] += int(seconds * 1e9)
            s[1] += 1

    def record_span(self, stage: str, parent: Optional[str], t0_ns: int,
                    t1_ns: int, cpu_ns: int) -> None:
        with self._lock:
            s = self._stats.setdefault(stage, [0, 0, 0])
            s[0] += t1_ns - t0_ns
            s[1] += 1
            s[2] += cpu_ns
            if self._spans is not None:
                self._spans.append((stage, parent, threading.get_ident(),
                                    getattr(self._batch, "id", None), t0_ns,
                                    t1_ns))

    def add_source(self, name: str,
                   fn: Callable[[], Dict[str, Tuple[float, int]]]) -> None:
        """Report the counters ``fn()`` returns, {stage: (seconds,
        count)}, beside this registry's own; ``name`` replaces an earlier
        source of that name."""
        with self._lock:
            self._sources[name] = fn

    def begin_batch(self) -> int:
        """Take the next batch id and make it this thread's current one:
        spans recorded on this thread carry it until the next call."""
        with self._lock:
            self._batches += 1
            self._batch.id = self._batches
        return self._batch.id

    def keep_spans(self, capacity: int) -> None:
        """Keep the newest ``capacity`` spans from now on (a fresh
        record); 0 stops and drops the record."""
        with self._lock:
            self._spans = deque(maxlen=capacity) if capacity > 0 else None

    def spans(self) -> List[tuple]:
        """The kept spans, oldest first (empty when the record is off)."""
        with self._lock:
            return list(self._spans or ())

    def report(self) -> Dict[str, dict]:
        """Per stage ``total_s``, ``count`` and ``mean_ms``; a span stage
        adds per-call means ``cpu_ms`` and ``offcpu_ms``, and a counter
        ``<stage>.offcpu`` (off-CPU seconds over the calls) for
        differences over a window."""
        with self._lock:
            stats = {k: list(v) for k, v in self._stats.items()}
            sources = list(self._sources.values())
        for fn in sources:
            for k, (sec, n) in fn().items():
                stats[k] = [int(sec * 1e9), n, None]

        def entry(ns: int, n: int) -> dict:
            return {"total_s": round(ns / 1e9, 4), "count": n,
                    "mean_ms": round(ns / 1e6 / max(n, 1), 3)}

        out: Dict[str, dict] = {}
        for s, (wall, n, cpu) in sorted(stats.items()):
            out[s] = entry(wall, n)
            if cpu is None:
                continue
            per = max(n, 1)
            out[s].update(cpu_ms=round(cpu / 1e6 / per, 3),
                          offcpu_ms=round((wall - cpu) / 1e6 / per, 3))
            out[f"{s}.offcpu"] = entry(wall - cpu, n)
        return out


@contextlib.contextmanager
def stage_timer(stage: str, times: StageTimes) -> Iterator[None]:
    """Time the body as span ``stage`` of ``times``; its parent is the
    innermost span open on this thread."""
    stack = _open_spans()
    parent = stack[-1][0] if stack else None
    stack.append((stage, times))
    t0 = time.monotonic_ns()  # the wall interval holds the CPU one
    c0 = time.thread_time_ns()
    try:
        yield
    finally:
        c1 = time.thread_time_ns()
        t1 = time.monotonic_ns()
        stack.pop()
        times.record_span(stage, parent, t0, t1, c1 - c0)
        log.debug("%s in %.3f s", stage, (t1 - t0) / 1e9)


def inner_timer(stage: str):
    """Span ``stage`` in the registry of the innermost span open on this
    thread, as its child; nothing where no span is open.  A component
    that several engines share (an encoder) times its parts into
    whichever engine is calling."""
    stack = _open_spans()
    if not stack:
        return contextlib.nullcontext()
    return stage_timer(stage, stack[-1][1])


def inner_record(stage: str, seconds: float) -> None:
    """One call of counter ``stage`` that took ``seconds``, in the
    registry ``inner_timer`` would pick; nothing where no span is open."""
    stack = _open_spans()
    if stack:
        stack[-1][1].record(stage, seconds)


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
