"""Kernel 4's share of its roofline: the bytes its inputs need (the whole bank
read once a batch, the queries, five [query, doc] outputs) at 3.35 TB/s,
over the device time of the kernels named below, in the profiled sub-window."""

from benchmark import readers

UNIT = "%"
SOURCE = "device_trace"
LAYER = "Kernel 4 (csrc/dense_stats.cu, retrieval/dense_stats.py)"
MOVES = "in_limit_pct"
KERNELS = ("stats_kernel",)


def read(ctx):
    return readers.roofline_pct(ctx, "dense_stats", KERNELS)
