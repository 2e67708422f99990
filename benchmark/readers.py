"""Arithmetic the metric readers in ``metrics/`` share.

Counters are read at the window's start and end (``ctx.c0``, ``ctx.c1``)
and around the profiled sub-window (``ctx.profile["c0"]``, ``["c1"]``).
Traced batches (``ctx.batches``) are those whose first engine call began
in the window.  Each function returns None where the run gave it nothing
to read.
"""

from __future__ import annotations

from typing import Iterable, Optional

from benchmark import roofline, stats
from benchmark.trace import busy_intervals, is_kernel


def latency_pct(ctx, q: float) -> Optional[float]:
    v = stats.pct(stats.latencies_ms(ctx.records), q)
    return v if v != stats.INF else None


def stage_ms(ctx, stage: str, c0=None, c1=None) -> Optional[float]:
    """Mean milliseconds a call of an engine stage (``StageTimes``)."""
    c0, c1 = c0 or ctx.c0, c1 or ctx.c1
    t0, n0 = c0["stages"].get(stage, (0.0, 0))
    t1, n1 = c1["stages"].get(stage, (0.0, 0))
    return (t1 - t0) / (n1 - n0) * 1e3 if n1 > n0 else None


def plane_batch_q(ctx) -> Optional[float]:
    dq = ctx.c1["plane"]["queries"] - ctx.c0["plane"]["queries"]
    db = ctx.c1["plane"]["batches"] - ctx.c0["plane"]["batches"]
    return dq / db if db else None


def stage3_ms(ctx) -> Optional[float]:
    """Stage-3 milliseconds a batch: the benchmark's spans around the
    cross-encoder's calls, summed in each traced batch."""
    ce = [b["ce_s"] for b in ctx.batches if "t1" in b and "ce_s" in b]
    return sum(ce) / len(ce) * 1e3 if ce else None


def finish_ms(ctx) -> Optional[float]:
    """Host finishing a batch on the data plane (``finish_indices``)."""
    return stage_ms(ctx, "finish_indices")


def _busy(ctx):
    p = ctx.profile
    ops = [(n, max(a, p["t0"]), min(b, p["t1"])) for n, a, b in p["ops"]
           if b > p["t0"] and a < p["t1"]]
    return sum(b - a for a, b in busy_intervals(ops))


def device_idle_pct(ctx) -> Optional[float]:
    """Share of the profiled sub-window with no device operation."""
    p = ctx.profile
    if not p or not p["ops"]:
        return None
    return 100.0 * (1.0 - _busy(ctx) / (p["t1"] - p["t0"]))


def launches_per_batch(ctx) -> Optional[float]:
    p = ctx.profile
    if not p:
        return None
    n_batches = (p["c1"]["stages"].get("device_rank", (0, 0))[1]
                 - p["c0"]["stages"].get("device_rank", (0, 0))[1])
    n = sum(1 for name, _, _ in p["ops"] if is_kernel(name))
    return n / n_batches if n_batches and n else None


def roofline_pct(ctx, layer: str, kernels: Iterable[str]) -> Optional[float]:
    """Least time of ``layer``'s bytes (from shapes) over the traced
    batches that ranked in the profiled sub-window, as a share of the
    device time of the kernels whose names hold one of ``kernels``."""
    p = ctx.profile
    if not p:
        return None
    names = tuple(kernels)
    t = sum(b - a for n, a, b in p["ops"] if any(k in n for k in names))
    work = [roofline.batch_work(b, ctx.shapes).get(layer)
            for b in ctx.batches if p["t0"] <= b.get("dr_start", -1) < p["t1"]]
    need = sum(roofline.least_time(*w) for w in work if w)
    return 100.0 * need / t if t > 0 and need > 0 else None


def batch_mfu_pct(ctx) -> Optional[float]:
    """Sum over the window's batches of the batch's least time (its
    operations at the bf16 peak or its bytes at the memory peak, the
    larger) over the sum of its wall time in engine calls."""
    least = wall = 0.0
    for b in ctx.batches:
        if "t1" not in b:
            continue
        work = roofline.batch_work(b, ctx.shapes).values()
        least += roofline.least_time(sum(w[0] for w in work),
                                     sum(w[1] for w in work))
        wall += b["wall"]
    return 100.0 * least / wall if wall > 0 and least > 0 else None
