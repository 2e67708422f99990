"""Mean ms a batch of host finishing on the data plane: the program's
StageTimes finish_indices."""

from benchmark import readers

UNIT = "ms"
SOURCE = "program_span"
LAYER = "Host finishing (retrieval/engine.py finish_batch, search_batch_indices)"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.finish_ms(ctx)
