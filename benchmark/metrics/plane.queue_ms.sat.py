"""A request's queue wait in a saturating data-plane cell (see
plane.queue_ms)."""

from benchmark import readers

UNIT = "ms"
SOURCE = "program_counter"
LAYER = "HTTP plane (serving/fastpath.py, native/http_server.cpp; serving/api.py, serving/batcher.py)"
MOVES = "qps"


def read(ctx):
    return readers.stage_ms(ctx, "plane_queue_wait")
