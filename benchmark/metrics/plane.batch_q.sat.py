"""Queries a device batch over the window of a saturating cell (see
plane.batch_q)."""

from benchmark import readers

UNIT = "queries/batch"
SOURCE = "program_counter"
LAYER = "HTTP plane (serving/fastpath.py, native/http_server.cpp; serving/api.py, serving/batcher.py)"
MOVES = "qps"


def read(ctx):
    return readers.plane_batch_q(ctx)
