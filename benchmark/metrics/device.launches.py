"""Kernels launched in the profiled sub-window over the device batches ranked
in it (device_rank calls)."""

from benchmark import readers

UNIT = "launches/batch"
SOURCE = "device_trace"
LAYER = "Device (enqueue)"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.launches_per_batch(ctx)
