"""Mean ms of the engine's query_encode stage: the host's enqueue of the
encoder forward on the device route."""

from benchmark import readers

UNIT = "ms"
SOURCE = "program_span"
LAYER = "Query encoder (models/encoder.py TorchEncoder via engine.encode_queries)"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.stage_ms(ctx, "query_encode")
