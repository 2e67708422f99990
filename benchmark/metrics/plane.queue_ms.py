"""Mean ms a request waited in the data plane's queue, from parsed to taken
into a batch by a dispatcher, the batch window included: the plane's
summed queue_wait_us over the requests it took (queued), in the window."""

from benchmark import readers

UNIT = "ms"
SOURCE = "program_counter"
LAYER = "HTTP plane (serving/fastpath.py, native/http_server.cpp; serving/api.py, serving/batcher.py)"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.stage_ms(ctx, "plane_queue_wait")
