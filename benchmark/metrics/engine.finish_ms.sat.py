"""Host finishing a batch in a saturating data-plane cell (see
engine.finish_ms)."""

from benchmark import readers

UNIT = "ms"
SOURCE = "program_span"
LAYER = "Host finishing (retrieval/engine.py finish_batch, search_batch_indices)"
MOVES = "qps"


def read(ctx):
    return readers.finish_ms(ctx)
