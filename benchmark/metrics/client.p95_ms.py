"""95th percentile latency of every /api/search request of the window (nearest
rank below), failed requests counted as infinite.  Per layer: run to run it
moves with the speed of the card's host, ~10-20% between runs of one seed,
more than the largest bound can hold (PERF.md, section 2)."""

from benchmark import readers

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "Client (every request, timed by the load generator)"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.latency_pct(ctx, 0.95)
