"""Mean ms a batch of the host's enqueue of the ranking kernels: the
engine's rank_enqueue span around _device_rank, inside device_rank."""

from benchmark import readers

UNIT = "ms"
SOURCE = "program_span"
LAYER = "Ranking dispatch (retrieval/engine.py device_rank: _device_rank, _to_host)"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.stage_ms(ctx, "rank_enqueue")
