"""Milliseconds a batch in the cross-encoder's rescore calls: the benchmark's
own span around each call, summed a batch."""

from benchmark import readers

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "Stage 3 (models/cross_encoder.py CrossEncoderReranker.rescore)"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.stage3_ms(ctx)
