"""The whole batch's share of the chip's peak in a saturating cell (see
batch_mfu)."""

from benchmark import readers

UNIT = "%"
SOURCE = "host_clock"
LAYER = "One device batch, whole"
MOVES = "qps"


def read(ctx):
    return readers.batch_mfu_pct(ctx)
