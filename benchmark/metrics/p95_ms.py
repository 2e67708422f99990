"""95th percentile latency of every /api/search request of the window (nearest
rank below), failed requests counted as infinite."""

from benchmark import readers

UNIT = "ms"
SOURCE = "host_clock"
LAYER = None
MOVES = None


def read(ctx):
    return readers.latency_pct(ctx, 0.95)
