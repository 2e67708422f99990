"""Requests answered with 200 inside the window, over the window's seconds (the
closed loop's throughput)."""

from benchmark import stats

UNIT = "q/s"
SOURCE = "host_clock"
LAYER = None
MOVES = None


def read(ctx):
    n = sum(1 for r in ctx.records if stats.ok(r) and r[3] <= ctx.t1)
    return n / ctx.seconds
