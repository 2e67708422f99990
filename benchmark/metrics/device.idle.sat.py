"""Device idle share in a saturating cell (see device.idle)."""

from benchmark import readers

UNIT = "%"
SOURCE = "device_trace"
LAYER = "Device"
MOVES = "qps"


def read(ctx):
    return readers.device_idle_pct(ctx)
