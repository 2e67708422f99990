"""Share of the dispatcher threads' wall time in the leaf host spans
(query_prep, encode_tokens, encode_forward, rank_enqueue, finish_indices)
that the thread spent off the CPU (wall minus thread CPU time), in the
window: blocked, preempted or asleep on a lock.  A kernel that lets a thread
spin for the interpreter lock counts that wait as CPU, and it reads here as
on the CPU."""

from benchmark import program_spans

UNIT = "%"
SOURCE = "program_span"
LAYER = "Host threads (utils/timing.py StageTimes: the dispatchers' leaf spans)"
MOVES = "in_limit_pct"


def read(ctx):
    return program_spans.offcpu_pct(ctx)
