"""Mean ms a batch of the rank callback's copy of the engine's rows into the
data plane's arrays (native/native_http.py, span plane_copy_out), in a
saturating cell."""

from benchmark import readers

UNIT = "ms"
SOURCE = "program_span"
LAYER = "HTTP plane (serving/fastpath.py, native/http_server.cpp; serving/api.py, serving/batcher.py)"
MOVES = "qps"


def read(ctx):
    return readers.stage_ms(ctx, "plane_copy_out")
