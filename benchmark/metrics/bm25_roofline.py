"""The BM25 kernels' share of their roofline: each distinct term's postings of
a batch once (a 4-byte doc id and a 4-byte impact), the query arrays and the
keyed output at 3.35 TB/s, over the device time of the kernels named below,
in the profiled sub-window."""

from benchmark import readers

UNIT = "%"
SOURCE = "device_trace"
LAYER = "BM25 kernels (csrc/bm25_slots.cu, retrieval/bm25_slots.py)"
MOVES = "in_limit_pct"
KERNELS = ("slots_kernel", "pack_afrag_kernel", "blocked_kernel",
           "blocked_udedup_kernel", "pack_weights_kernel")


def read(ctx):
    return readers.roofline_pct(ctx, "bm25", KERNELS)
