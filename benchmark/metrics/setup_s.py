"""Seconds from the process's start to the window's first scheduled request:
index, weights, program, plane, warm-up, load generator."""

UNIT = "s"
SOURCE = "host_clock"
LAYER = None
MOVES = None


def read(ctx):
    return ctx.setup_s
