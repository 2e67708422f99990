"""Readings of the program's own spans and counters (the port's
``utils/timing.StageTimes``, reported through ``engine.times.report()``).

The metric readers difference the counters at the window's two ends
(``ctx.c0``, ``ctx.c1``); each returns None where the program does not
record what it reads.  ``idle_by_program_span`` attributes the device's
idle gaps by the program's span record (``StageTimes.keep_spans``), and
``span_cost_ns`` measures what a span costs on the host it runs on; a
traced run that switches the record on around its profile uses both.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

# the dispatcher threads' host spans that hold no other span
LEAF_HOST_STAGES = ("query_prep", "encode_tokens", "encode_forward",
                    "rank_enqueue", "finish_indices")


def _delta(ctx, key: str):
    t0, n0 = ctx.c0["stages"].get(key, (0.0, 0))
    t1, n1 = ctx.c1["stages"].get(key, (0.0, 0))
    return t1 - t0, n1 - n0


def offcpu_pct(ctx, stages=LEAF_HOST_STAGES) -> Optional[float]:
    """Share of the wall time in ``stages`` during the window in which
    the thread was off the CPU: Σ(wall − thread CPU) / Σ wall."""
    if not any(f"{s}.offcpu" in ctx.c1["stages"] for s in stages):
        return None
    wall = sum(_delta(ctx, s)[0] for s in stages)
    off = sum(_delta(ctx, f"{s}.offcpu")[0] for s in stages)
    return 100.0 * off / wall if wall > 0 else None


def innermost_segments(spans: List[tuple]) -> Dict[int, List[tuple]]:
    """Per thread, (start, end, name) pieces of time in seconds, each
    under the innermost of the thread's spans open there.  ``spans`` are
    the program's records (name, parent, thread, batch, t0_ns, t1_ns)."""
    by_thread: Dict[int, List[tuple]] = {}
    for name, _, ident, _, a, b in spans:
        by_thread.setdefault(ident, []).append((a / 1e9, b / 1e9, name))
    out = {}
    for ident, ss in by_thread.items():
        ss.sort()
        cuts = sorted({t for a, b, _ in ss for t in (a, b)})
        segs, active, at = [], [], 0
        for lo, hi in zip(cuts, cuts[1:]):
            while at < len(ss) and ss[at][0] <= lo:
                active.append(ss[at])
                at += 1
            active = [s for s in active if s[1] > lo]
            if active:
                inner = max(active, key=lambda s: (s[0], -s[1]))
                segs.append((lo, hi, inner[2]))
        out[ident] = segs
    return out


def idle_by_program_span(busy: List[tuple], spans: List[tuple], t0: float,
                         t1: float) -> Dict[str, float]:
    """Seconds the device sat idle in [t0, t1), by the innermost program
    span open on each thread at each gap's middle, names joined by "+"
    ("plane" where no thread had one open)."""
    gaps, at = [], t0
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, t1)))
        at = max(at, b)
    if at < t1:
        gaps.append((at, t1))
    segs = innermost_segments(spans)
    pos = dict.fromkeys(segs, 0)
    out: Dict[str, float] = {}
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        names = []
        for ident, ss in segs.items():
            i = pos[ident]
            while i < len(ss) and ss[i][1] <= mid:
                i += 1
            pos[ident] = i
            if i < len(ss) and ss[i][0] <= mid:
                names.append(ss[i][2])
        key = "+".join(sorted(names)) or "plane"
        out[key] = out.get(key, 0.0) + (b - a)
    return out


def span_cost_ns(n: int = 100_000) -> Dict[str, float]:
    """Nanoseconds a ``stage_timer`` span costs on this host, with the
    span record off and on."""
    from modern_search_engines_project_tpu_torch.utils.timing import (
        StageTimes,
        stage_timer,
    )

    out = {}
    for mode, cap in (("off", 0), ("on", n)):
        times = StageTimes()
        times.keep_spans(cap)
        t = time.perf_counter_ns()
        for _ in range(n):
            with stage_timer("s", times):
                pass
        out[mode] = (time.perf_counter_ns() - t) / n
    return out
