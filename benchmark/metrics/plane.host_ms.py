"""Mean ms a request spent in the serving process, from parsed to its reply
handed to the event thread: the data plane's summed host_us over its
replies (served), in the window."""

from benchmark import readers

UNIT = "ms"
SOURCE = "program_counter"
LAYER = "HTTP plane (serving/fastpath.py, native/http_server.cpp; serving/api.py, serving/batcher.py)"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.stage_ms(ctx, "plane_host")
