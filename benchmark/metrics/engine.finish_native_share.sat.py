"""Share of the window's host finishing passes that ran as one native call:
100 x the window's finish_native spans (one a batch, around the call into
native/finish.cpp) over its finish_indices spans (one a data-plane batch,
whichever path ran).  A program that records no native pass has nothing
here to read."""

UNIT = "%"
SOURCE = "program_counter"
LAYER = "Host finishing (retrieval/engine.py finish_batch, search_batch_indices)"
MOVES = "qps"


def read(ctx):
    if "finish_native" not in ctx.c1["stages"]:
        return None
    native, finish = (
        ctx.c1["stages"].get(k, (0.0, 0))[1] - ctx.c0["stages"].get(k, (0.0, 0))[1]
        for k in ("finish_native", "finish_indices"))
    return 100.0 * native / finish if finish > 0 else None
