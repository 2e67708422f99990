"""The controls of ``correct``: lower precision must come out not correct.

    python3 -m benchmark.control --workload api.steady --seeds 1,2,3 \\
        --seconds 10 --out chiprun_out/control_api.json

For each seed, on the chip at the cell's own size:

  * ``fp8``: the reference put in the program's place, its encoders'
    weight products and the window cosines rounded to float8 e4m3 (the
    step below the bf16 the configuration states), judged against the
    float32 reference on ``correct.sample`` queries of the cell's query
    model drawn from that seed;
  * ``int8_bank``: the program with its own lower-precision path switched
    on (``bank_dtype="int8"``, the serving CLI's ``--int8-bank``), a
    ``--seconds`` run at the cell's load.

Each is judged by ``check.verdict``, the expression that decides a run's
``correct``; prints and writes the numbers beside the cell's limits and
the verdict, which has to be false.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def fp8_served(cfg: dict, corp, seed: int, queries, device) -> dict:
    """query -> the rows the float8 reference would serve."""
    from benchmark import reference, weights

    ref = reference.Reference(corp, cfg["engine"], bank_cast=reference.fp8_rows)
    enc = cfg["encoder"]
    qvec = reference.embed(weights.draw_tree(seed, enc, False, device), enc,
                           reference.HashTokens(enc["vocab_size"]),
                           [reference.processed(q) for q in queries], device,
                           cast=reference.fp8)
    ce_cfg = cfg.get("cross_encoder")
    if ce_cfg:
        cw = weights.draw_tree(seed, ce_cfg, True, device)
        ctok = reference.HashTokens(ce_cfg["vocab_size"])
    out = {}
    for q, v in zip(queries, qvec):
        st2 = ref.stage2(q, v)
        rows = list(zip(st2.docs.tolist(), st2.wins.tolist(),
                        st2.scores.tolist()))
        if ce_cfg:
            ce = reference.cross_scores(
                cw, ce_cfg, ctok, q, [corp.window_texts[w] for _, w, _ in rows],
                device, cast=reference.fp8)
            order = np.argsort(-ce, kind="stable")
            rows = [(rows[i][0], rows[i][1], float(ce[i])) for i in order]
        out[q] = rows
    return out


def sample_queries(cell: dict, corp, seed: int):
    """The queries the fp8 control answers: ``correct.sample`` of the
    cell's query model, drawn from ``seed`` as a run draws its own."""
    from benchmark import queries

    return queries.draw_queries(seed, corp.words, corp.dfs,
                                cell["config"]["correct"]["sample"],
                                cell["traffic"]["queries"])


def fp8_checks(cell: dict, corp, seed: int, device) -> dict:
    """The fp8 control's numbers beside the cell's limits."""
    from benchmark import check
    from benchmark.kinds import search

    cfg = cell["config"]
    served = fp8_served(cfg, corp, seed, sample_queries(cell, corp, seed),
                        device)
    return check.checks(search.judge_served(cfg, corp, seed, served, device),
                        cfg["correct"]["limits"])


def main(argv=None) -> int:
    from benchmark import cells, check, corpus as corpus_mod, run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    cfg = cell["config"]
    res = {"workload": args.workload, "limits": cfg["correct"]["limits"],
           "seeds": {}}
    for seed in args.seeds:
        corp = corpus_mod.make_corpus(seed, cfg["corpus"], "cuda")
        fp8 = fp8_checks(cell, corp, seed, "cuda")
        del corp
        r = run.run_cell(cell, seed, args.seconds, False, bank_dtype="int8")
        one = {"seed": seed,
               "fp8": {"correct": check.verdict(fp8), "checks": fp8},
               "int8_bank": {"correct": r["correct"], "checks": r["checks"]}}
        res["seeds"][str(seed)] = one
        print(json.dumps(one), file=sys.stderr, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1) + "\n")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
