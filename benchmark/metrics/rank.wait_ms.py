"""Mean ms a batch the dispatcher waits for the ranked rows to come back
from the device: the engine's rank_wait span around _to_host, inside
device_rank."""

from benchmark import readers

UNIT = "ms"
SOURCE = "program_span"
LAYER = "Ranking dispatch (retrieval/engine.py device_rank: _device_rank, _to_host)"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.stage_ms(ctx, "rank_wait")
