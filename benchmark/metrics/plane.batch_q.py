"""Queries a device batch over the window, from the plane's counters (data
plane: batched_queries / batches; control plane: batcher requests /
device_batches)."""

from benchmark import readers

UNIT = "queries/batch"
SOURCE = "program_counter"
LAYER = "HTTP plane (serving/fastpath.py, native/http_server.cpp; serving/api.py, serving/batcher.py)"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.plane_batch_q(ctx)
