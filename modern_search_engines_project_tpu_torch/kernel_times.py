"""Device times of kernels 1-3, 5 and 6 (slot BM25), 4 (dense stats) and 7-8
(blocked BM25) at the paths' shapes, on the 100k-doc synthetic index that
``chip_smoke.py`` builds, printed as one JSON line.

    python3 -m modern_search_engines_project_tpu_torch.kernel_times [--seed 0]

Run as a file, it imports whichever ``modern_search_engines_project_tpu_torch``
comes first on ``PYTHONPATH``, so the same code times the kernels of
another checkout of the port on the same card:

    PYTHONPATH=<checkout> python3 modern_search_engines_project_tpu_torch/kernel_times.py

Kernel 4 is timed over all buckets of the slot index, and bucket by bucket
([n, cnt] of each in "buckets"), at B = 1, 16 and 64 unit-norm queries;
kernel 7 on the blocked index at B = 1, 16 and 64
df-drawn queries of T = 8 term slots (``synthetic.sample_terms``).  Kernel
1 on the slot index at B = 1, 16 and 64 df-drawn queries of T = 8, kernels
2 and 3 at B = 16 / U = 128 and B = 64 / U = 256 (df-drawn, redrawn until
the batch pads to that U) and B = 64 / U = 1024 (16 uniform terms a
query); kernels 5 ("acc", the legacy U-dedup default) and 6 ("wide",
"wide_i8") at B = 16 / U = 128 and B = 64 / U = 256, on the batches of
kernels 2-3; kernel 8 on the blocked index at B = 64 / U = 128
from the 100 most frequent terms (the batch that passes the blocked
U-dedup gate) and at the df-drawn B = 64.  Each BM25 kernel of these rows
runs both back to back ("warm": the 33.8 MB of term ids stay in the 50 MB
L2) and after a write of 128 MB that evicts L2 ("cold": the time of write
and kernel less the write's), and the row carries a digest of the
kernel's output bytes (``sha256``, 16 hex digits), so two checkouts timed
on the same seed show whether a kernel's bits changed.  Inputs come from
``--seed``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
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


def cold_ms(fn, reps, flush):
    """Device time of one ``fn()`` that finds L2 cold: ``flush(); fn()``
    less ``flush()`` alone, each timed by ``device_ms``."""
    both = device_ms(lambda: (flush(), fn()), reps)
    return both - device_ms(flush, reps)


def digest(t: torch.Tensor) -> str:
    """First 16 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


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
        bm25_score_blocked_udedup,
    )
    from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
        dedup_query_terms,
        slots_keyed,
        slots_udedup_keyed,
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
    slot_idx = SearchEngine(art, enc, cfg).didx
    banks = slot_idx.bucket_emb
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
    # kernels 1-3 on the slot index
    st = slot_idx.slot_stream
    views = (slot_idx.slot_terms, slot_idx.slot_impact)
    scratch = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    flush = scratch.zero_

    def timed(fn):
        return {"warm": device_ms(fn, args.reps),
                "cold": cold_ms(fn, args.reps, flush),
                "digest": digest(fn())}

    for B in (1, 16, 64):
        tids, qtf = sample_terms(rng, dfs, B, 8)
        t = torch.as_tensor(tids, device=dev)
        q = torch.as_tensor(qtf, device=dev)
        out.setdefault("bm25_slots", {})[f"B={B} T=8"] = timed(
            lambda: slots_keyed(st, *views, t, q))
    for B, U, T, by_df in ((16, 128, 8, True), (64, 256, 8, True),
                           (64, 1024, 17, False)):
        while True:
            tids, qtf = sample_terms(rng, dfs, B, T, by_df)
            uids, w = dedup_query_terms(tids, qtf)
            if uids.size == U:
                break
        u = torch.as_tensor(uids, device=dev)
        wt = torch.as_tensor(w, device=dev)
        # kernels 5-6 at the legacy default's shapes only
        for variant in ("sublane", "i8") + (
                ("acc", "wide", "wide_i8") if U <= 256 else ()):
            out.setdefault(f"bm25_slots_udedup_{variant}", {})[
                f"B={B} U={U}"] = timed(
                lambda v=variant: slots_udedup_keyed(st, *views, u, wt, v))
    # kernel 8 on the blocked index: the B = 64 batch of the 100 most
    # frequent terms (U = 128, the gate's batch) and a df-drawn one
    for key, pool in (("B=64 U=128 shared", 100), ("B=64 df-drawn", None)):
        tids, qtf = sample_terms(rng, dfs, 64, 8, pool=pool)
        uids, w = dedup_query_terms(tids, qtf)
        u = torch.as_tensor(uids, device=dev)
        wt = torch.as_tensor(w, device=dev)
        row = timed(lambda: bm25_score_blocked_udedup(blk, u, wt))
        out.setdefault("bm25_blocked_udedup", {})[f"{key} (U={uids.size})"] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
