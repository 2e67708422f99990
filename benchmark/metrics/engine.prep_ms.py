"""Mean ms of the engine's query_prep stage (StageTimes) over the window's
batches."""

from benchmark import readers

UNIT = "ms"
SOURCE = "program_span"
LAYER = "Host query prep (retrieval/engine.py prepare_queries, text/)"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.stage_ms(ctx, "query_prep")
