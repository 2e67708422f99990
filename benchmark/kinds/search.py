"""The search kind: ``POST /api/search`` of the port's engine.

A run of this kind makes the configuration's corpus and draws the
encoders' weights from the seed on the device (``benchmark/corpus.py``,
``benchmark/weights.py``), starts the engine behind the plane the
configuration names (``benchmark/planes.py``), sends ``{"query": ...}``
bodies of the traffic's query model (``benchmark/queries.py``) and judges
the served rows against the plain reference (``benchmark/reference.py``,
``benchmark/check.py``).  A configuration that names no ``kind`` is of
this one.

The load generator loads this module for ``stream`` alone, in its own
process: torch and the program are imported inside the functions that
need them, so they stay out of its start-up.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark import queries

PATH = "/api/search"


class State:
    """What a run keeps besides the program: the corpus, the warm-up
    batches (the last one's first three queries went through the plane,
    so the window never sends them) and how many of the engine's dense
    banks are not of the configuration's type."""

    def __init__(self, corp, warm: List[List[str]], bank_off: int = 0):
        self.corp, self.warm, self.bank_off = corp, warm, bank_off


def warm_batches(seed: int, corp, traffic: Dict) -> List[List[str]]:
    w = traffic["warm"]
    sizes = [b for b in w["batch_sizes"] for _ in range(w["repeats"])]
    qs = queries.draw_queries(seed, corp.words, corp.dfs, sum(sizes),
                              traffic["queries"], stream=5)
    out, at = [], 0
    for b in sizes:
        out.append(qs[at : at + b])
        at += b
    return out


def start(cell: Dict, seed: int, device, marks: Dict, faults=None,
          bank_dtype=None):
    """The program serving the corpus, started and warmed, and the run's
    ``State``.  ``marks`` gets the monotonic time at which each stage of
    set-up ended; ``bank_dtype`` goes to the engine; ``faults``, where
    given, is called with the warm engine (the tests' broken paths)."""
    from benchmark import corpus as corpus_mod, weights
    from benchmark.planes import Program

    cfg = cell["config"]
    corp = corpus_mod.make_corpus(seed, cfg["corpus"], device)
    corp.freeze()
    marks["corpus"] = time.monotonic()
    enc_np = weights.to_numpy(weights.draw_tree(seed, cfg["encoder"], False,
                                                device))
    ce_np = None
    if cfg.get("cross_encoder"):
        ce_np = weights.to_numpy(weights.draw_tree(
            seed, cfg["cross_encoder"], True, device))
    marks["weights"] = time.monotonic()
    prog = Program(cfg, corp, enc_np, ce_np, device, bank_dtype=bank_dtype)
    del enc_np, ce_np
    try:
        prog.start()
        marks["program"] = time.monotonic()
        warm = warm_batches(seed, corp, cell["traffic"])
        prog.warm(warm)
        marks["warm-up"] = time.monotonic()
        state = State(corp, warm,
                      prog.banks_not_of(cfg["corpus"]["bank_dtype"]))
        if faults is not None:
            faults(prog.engine)
    except BaseException:
        prog.stop()
        raise
    return prog, state


def plan(cell: Dict, seed: int, seconds: float, state: State) -> Dict:
    """The load generator's header and the open loop's request bodies.

    The open loop's requests are all known ahead: their bodies go with
    the header, and the judged sample is drawn from them here.  The
    closed loop draws a fresh query of the same model for each request it
    sends (``stream``), and keeps a seeded uniform sample of
    ``correct.sample`` of them (``loadgen.Reservoir``)."""
    traffic, cfg, corp = cell["traffic"], cell["config"], state.corp
    exclude = set(state.warm[-1][:3])
    header = {"loop": traffic["loop"], "path": PATH, "seconds": seconds,
              "drain_s": traffic["drain_s"]}
    if traffic["loop"] != "open":
        header.update(connections=traffic["connections"],
                      sample=cfg["correct"]["sample"],
                      draw={"seed": int(seed), "words": list(corp.words),
                            "dfs": np.asarray(corp.dfs).tolist(),
                            "model": traffic["queries"],
                            "exclude": sorted(exclude)})
        return {"header": header, "bodies": []}
    offsets = queries.arrivals(seed, traffic["rate_qps"], seconds)
    n = len(offsets)
    rng = np.random.default_rng([int(seed), 4])
    keep = rng.choice(n, min(n, cfg["correct"]["sample"]), replace=False)
    qs = queries.draw_queries(seed, corp.words, corp.dfs, n + len(exclude),
                              traffic["queries"])
    qs = [q for q in qs if q not in exclude][:n]
    header.update(offsets=offsets.tolist(),
                  max_connections=traffic["max_connections"],
                  keep=sorted(int(k) for k in keep))
    return {"header": header, "bodies": [json.dumps({"query": q}) for q in qs]}


def stream(draw: Dict):
    """The closed loop's next request body, a fresh query of ``draw``'s
    model each call (``queries.QueryStream``)."""
    s = queries.QueryStream(draw["seed"], draw["words"], draw["dfs"],
                            draw["model"], exclude=draw["exclude"])
    return lambda: json.dumps({"query": s.next()})


def spans(program, state: State, cell: Dict):
    """The benchmark's spans around the engine's calls (``trace.Spans``)."""
    from benchmark import trace

    s = trace.Spans(state.corp, cell["config"]["encoder"])
    s.install(program.engine)
    return s


def shapes(state: State, cell: Dict) -> Dict:
    """What the roofline counts read (``ctx.shapes``)."""
    cfg, corp = cell["config"], state.corp
    return {"n_docs": corp.n_docs, "n_chunks": corp.n_chunks,
            "dim": cfg["corpus"]["dim"], "bank_dtype": cfg["corpus"]["bank_dtype"],
            "encoder": cfg["encoder"], "cross_encoder": cfg.get("cross_encoder")}


def parse_reply(body: str):
    """Served rows of a reply, or None where it is no search reply."""
    from benchmark import check

    try:
        return check.served_rows(body)
    except (ValueError, KeyError, TypeError):
        return None


def judge_served(cfg: Dict, corp, seed: int, served: Dict,
                 device) -> Dict[str, float]:
    """The numbers compared over ``served`` (query -> served rows, or None
    for a reply that is no search reply)."""
    import torch

    from benchmark import check, reference, weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference.Reference(corp, cfg["engine"])
    enc_cfg, ce_cfg = cfg["encoder"], cfg.get("cross_encoder")
    qs = list(served)
    qvec = reference.embed(
        weights.draw_tree(seed, enc_cfg, False, device), enc_cfg,
        reference.HashTokens(enc_cfg["vocab_size"]),
        [reference.processed(q) for q in qs], device)
    if ce_cfg:
        cw = weights.draw_tree(seed, ce_cfg, True, device)
        ctok = reference.HashTokens(ce_cfg["vocab_size"])
    out: Dict[str, float] = {}
    for q, v in zip(qs, qvec):
        rows = served[q]
        if rows is None:
            nums = dict.fromkeys(cfg["correct"]["limits"], 1.0)
        elif ce_cfg:
            texts = [corp.window_texts[w] if 0 <= w < corp.n_chunks else ""
                     for _, w, _ in rows]
            ce = reference.cross_scores(cw, ce_cfg, ctok, q, texts, device)
            nums = check.stage3_numbers(rows, ref.stage2(q, v), ce, ref.domain)
        else:
            nums = check.stage2_numbers(rows, ref.stage2(q, v), ref.domain)
        for k, x in nums.items():
            out[k] = max(out.get(k, 0.0), x)
    return out


def judge(cell: Dict, seed: int, state: State,
          sample: List[Tuple[str, str]],
          device) -> Tuple[Dict[str, float], Dict[str, int]]:
    """The numbers and counts held to the configuration's limits, over
    the sampled (request body, reply body) pairs: ``judge_served``'s
    gaps, and ``bank_dtype_off``."""
    served: Dict[str, Optional[list]] = {
        json.loads(req)["query"]: parse_reply(reply) for req, reply in sample}
    return (judge_served(cell["config"], state.corp, seed, served, device),
            {"bank_dtype_off": state.bank_off})
