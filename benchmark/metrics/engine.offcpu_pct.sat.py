"""Off-CPU share of the leaf host spans in a saturating cell (see
engine.offcpu_pct)."""

from benchmark import program_spans

UNIT = "%"
SOURCE = "program_span"
LAYER = "Host threads (utils/timing.py StageTimes: the dispatchers' leaf spans)"
MOVES = "qps"


def read(ctx):
    return program_spans.offcpu_pct(ctx)
