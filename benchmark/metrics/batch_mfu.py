"""Sum over the window's batches of the batch's least time (operations at 989
TFLOP/s bf16 or bytes at 3.35 TB/s, the larger; encoder, BM25, dense
statistics, stage 3, from shapes) over the sum of its wall time in engine
calls."""

from benchmark import readers

UNIT = "%"
SOURCE = "host_clock"
LAYER = "One device batch, whole"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.batch_mfu_pct(ctx)
