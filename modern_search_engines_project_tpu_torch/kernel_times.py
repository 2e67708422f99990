"""Device times of kernels 4 (dense stats) and 7 (blocked BM25) at the main
path's shapes, on the 100k-doc synthetic index that ``chip_smoke.py``
builds, printed as one JSON line.

    python3 -m modern_search_engines_project_tpu_torch.kernel_times [--seed 0]

Run as a file, it imports whichever ``modern_search_engines_project_tpu_torch``
comes first on ``PYTHONPATH``, so the same code times the kernels of
another checkout of the port on the same card:

    PYTHONPATH=<checkout> python3 modern_search_engines_project_tpu_torch/kernel_times.py

Kernel 4 is timed over all buckets of the slot index, and bucket by bucket
([n, cnt] of each in "buckets"), at B = 1, 16 and 64 unit-norm queries;
kernel 7 on the blocked index at B = 1, 16 and 64
df-drawn queries of T = 8 term slots (``synthetic.sample_terms``).  Inputs
come from ``--seed``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

if __name__ == "__main__":  # run as a file: its folder is no top-level root
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _here]

import numpy as np
import torch


def device_ms(fn, reps, warmup=2):
    """Device time of one ``fn()`` in ms: ``reps`` calls queued behind a
    sleep kernel that outlasts their enqueue, timed with CUDA events, so
    the host's time to enqueue them is not counted.  ``fn`` must not
    synchronize with the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 21
    for _ in range(8):
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if s.elapsed_time(a) > enqueue_ms:  # the queue never ran dry
            return a.elapsed_time(b) / reps
        cycles *= 4
    raise RuntimeError("device_ms: the sleep never outlasted the enqueue")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1

    from modern_search_engines_project_tpu_torch.config import Config
    from modern_search_engines_project_tpu_torch.models import HashingEncoder
    from modern_search_engines_project_tpu_torch.retrieval.bm25_blocked import (
        bm25_score_blocked,
    )
    from modern_search_engines_project_tpu_torch.retrieval.dense_stats import (
        bucket_stats,
    )
    from modern_search_engines_project_tpu_torch.retrieval.engine import (
        SearchEngine,
    )
    from modern_search_engines_project_tpu_torch.synthetic import (
        make_artifacts,
        sample_terms,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    art, _, dfs = make_artifacts(args.seed)
    cfg = Config()
    enc = HashingEncoder(dim=cfg.embedding_dim)
    banks = SearchEngine(art, enc, cfg).didx.bucket_emb
    blk = SearchEngine(art, enc, cfg.replace(bm25_layout="blocked")).didx.blocked
    dev = banks[0].device
    rng = np.random.default_rng(args.seed)
    out = {"device": smi, "buckets": [list(e.shape[:2]) for e in banks],
           "dense_stats": {}, "dense_stats_per_bucket": {},
           "bm25_blocked": {}}
    for B in (1, 16, 64):
        qv = rng.standard_normal((B, banks[0].shape[2])).astype(np.float32)
        qv = torch.as_tensor(qv / np.linalg.norm(qv, axis=1, keepdims=True),
                             device=dev)
        out["dense_stats"][f"B={B}"] = device_ms(
            lambda: [bucket_stats(e, qv) for e in banks], args.reps)
        out["dense_stats_per_bucket"][f"B={B}"] = [
            device_ms(lambda e=e: bucket_stats(e, qv), args.reps)
            for e in banks
        ]
        tids, qtf = sample_terms(rng, dfs, B, 8)
        t = torch.as_tensor(tids, device=dev)
        q = torch.as_tensor(qtf, device=dev)
        out["bm25_blocked"][f"B={B}"] = device_ms(
            lambda: bm25_score_blocked(blk, t, q), args.reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
