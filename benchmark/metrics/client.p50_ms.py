"""Median latency of every /api/search request of the window, from when it was
due to the last byte of its reply; a failed request counts as infinite.  Per
layer, as ``client.p95_ms``: run to run it moves with the host's speed more than
a bound can hold (PERF.md, section 2)."""

from benchmark import readers

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "Client (every request, timed by the load generator)"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.latency_pct(ctx, 0.5)
