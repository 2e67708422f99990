"""Share of the query encoder's forwards in the window that replayed a CUDA
graph: 100 x the window's encode_graph counts (one a replay) over its
encode_forward spans (one a chunk, whichever path ran).  A program that
counts no replay has nothing here to read."""

UNIT = "%"
SOURCE = "program_counter"
LAYER = "Query encoder (models/encoder.py TorchEncoder via engine.encode_queries)"
MOVES = "in_limit_pct"


def read(ctx):
    if "encode_graph" not in ctx.c1["stages"]:
        return None
    graph, forward = (
        ctx.c1["stages"].get(k, (0.0, 0))[1] - ctx.c0["stages"].get(k, (0.0, 0))[1]
        for k in ("encode_graph", "encode_forward"))
    return 100.0 * graph / forward if forward > 0 else None
