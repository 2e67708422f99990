"""Share of the profiled sub-window in which no operation ran on the device
(torch.profiler, the union of operation intervals)."""

from benchmark import readers

UNIT = "%"
SOURCE = "device_trace"
LAYER = "Device"
MOVES = "in_limit_pct"


def read(ctx):
    return readers.device_idle_pct(ctx)
