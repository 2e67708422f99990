#!/usr/bin/env python3
"""Drive the torch port of the hybrid search engine on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the repository root.  It needs a CUDA device and exits non-zero,
printing no result, without one.  Phases (each failure ends the run with a
non-zero exit):

  1. device: the card's name and power limit;
  2. build: one nvcc call compiles csrc/*.cu (seconds are printed);
  3. index: synthetic IndexArtifacts in the shape of the repository's
     bench corpus (100k docs, 50k-term Zipf(0.7) vocabulary, ~80 postings
     per doc with gamma(2, 1.5) impacts, 1 + Poisson(2) chunks per doc
     capped at 10, unit-norm 768-d chunk vectors), made from --seed, and
     the port's SearchEngine built over it on the card;
  4. kernels: every kernel of the path against its plain PyTorch version
     on the same tensors at the path's shapes, with times (CUDA events);
  5. end to end: SearchEngine.search_batch on batches of 1, 16 and 64
     queries (one per BM25 dispatch branch), the launch counters set to 0
     before each batch and read after it (exactly that branch's BM25
     kernel once, the stats kernel once per bucket), results held against
     the port's own engine on the CPU and against its numpy oracle, then
     queries/s, p50 latency and one torch.profiler trace per batch
     (device busy time, idle share, device time per kernel);
  6. a {"kernels": [...]} JSON line (time, bound, plain time, error per kernel),
     the nvidia-smi line, and the final {"ok": true, ...} line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import IndexArtifacts
from modern_search_engines_project_tpu_torch.index.vocab import TermDictionary
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.retrieval import cuda_lib
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    UDEDUP_KERNELS,
    dedup_query_terms,
    slots_keyed,
    slots_plain,
    slots_udedup_keyed,
    slots_udedup_plain,
)
from modern_search_engines_project_tpu_torch.retrieval.dense_stats import (
    bucket_sims,
    bucket_stats,
    stats_max_abs_err,
    stats_plain,
)
from modern_search_engines_project_tpu_torch.retrieval.engine import SearchEngine
from modern_search_engines_project_tpu_torch.retrieval.numpy_ref import (
    hybrid_search_numpy,
    preprocess_query,
)
from modern_search_engines_project_tpu_torch.text.analyzer import Analyzer
from modern_search_engines_project_tpu_torch.utils.timing import StageTimes

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 on
# the CUDA cores, bf16 on the tensor cores.
HBM_BPS = 3.35e12
F32_OPS = 67e12
BF16_OPS = 989e12

# Tolerances.  BM25: every kernel sums at most T nonzero f32 products per
# doc, in another order than its plain version -> keyed scores to 1e-5.
# Stats: kernel and plain version read the same bf16 bank and query and
# sum 768 f32 products in different orders (~1e-6); 1e-4 leaves room.
BM25_ATOL = 1e-5
STATS_ATOL = 1e-4
# End to end: the card's engine and the CPU engine (same bf16 bank) differ
# only in summation order inside the stats and the f32 fusion arithmetic;
# after min-max normalization that stays far below 1e-3.  Ids must match
# except where neighbouring fused scores lie within 1e-3 of each other.
E2E_ATOL = 1e-3


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _letters(n: int) -> str:
    s = ""
    n += 1
    while n:
        n, r = divmod(n - 1, 26)
        s = chr(ord("a") + r) + s
    return s


def make_artifacts(seed, n_docs, n_terms, nnz_target, avg_chunks, dim):
    """Synthetic index in the bench corpus's shape.  Term 0 is the anchor
    "tuebingen" that query preprocessing appends to every query."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_terms + 1)
    dfs = (1.0 / ranks) ** 0.7
    dfs = np.maximum((dfs / dfs.sum() * nnz_target).astype(np.int64), 1)
    dfs = np.minimum(dfs, n_docs)
    # one posting per (term, doc): duplicate draws collapse
    pairs = np.unique(
        np.repeat(np.arange(n_terms, dtype=np.int64), dfs) * n_docs
        + rng.integers(0, n_docs, int(dfs.sum()))
    )
    terms = pairs // n_docs
    post_docs = (pairs % n_docs).astype(np.int32)
    df = np.bincount(terms, minlength=n_terms).astype(np.int32)
    indptr = np.zeros(n_terms + 1, np.int32)
    np.cumsum(df, out=indptr[1:])
    post_impact = rng.gamma(2.0, 1.5, post_docs.size).astype(np.float32)

    doc_n = np.minimum(1 + rng.poisson(avg_chunks - 1.0, n_docs), 10)
    doc_n = doc_n.astype(np.int32)
    n_chunks = int(doc_n.sum())
    chunk_doc = np.repeat(np.arange(n_docs, dtype=np.int32), doc_n)
    doc_start = np.zeros(n_docs, np.int32)
    np.cumsum(doc_n[:-1], out=doc_start[1:])
    emb = rng.standard_normal((n_chunks, dim), dtype=np.float32)
    emb /= np.sqrt(np.einsum("ij,ij->i", emb, emb))[:, None]

    words = ["tuebingen"] + [f"z{_letters(i)}q" for i in range(n_terms - 1)]
    an = Analyzer()
    check(all(an.tokens(w) == [w] for w in words), "vocab not analyzer-stable")
    doc_len = np.bincount(post_docs, minlength=n_docs).astype(np.int32)
    n_dom = 2000
    urls = [f"https://www.site{i % n_dom}.de/page{i}" for i in range(n_docs)]
    art = IndexArtifacts(
        indptr=indptr,
        post_docs=post_docs,
        post_impact=post_impact,
        idf=np.log((n_docs - df + 0.5) / (df + 0.5)).astype(np.float32),
        df=df,
        doc_len=doc_len,
        avgdl=float(doc_len.mean()),
        chunk_emb=emb,
        chunk_doc=chunk_doc,
        doc_chunk_start=doc_start,
        doc_n_chunks=doc_n,
        vocab=TermDictionary({w: i for i, w in enumerate(words)}),
        doc_ids=list(range(10**6, 10**6 + n_docs)),
        urls=urls,
        titles=[f"page {i}" for i in range(n_docs)],
        domains=[f"www.site{i % n_dom}.de" for i in range(n_docs)],
        snippets=[f"page {i}: ..." for i in range(n_docs)],
        window_texts=[f"window {i}" for i in range(n_chunks)],
        config=Config(embedding_dim=dim),
    )
    return art, words, dfs


def sample_terms(rng, dfs, B, T, by_df=True):
    """Per query 1-5 terms (by document frequency, or uniform), as in the
    bench's query model; returns (term_ids [B, T] pad -1, qtf [B, T])."""
    n_terms = len(dfs)
    probs = dfs / dfs.sum() if by_df else None
    tids = np.full((B, T), -1, np.int32)
    qtf = np.zeros((B, T), np.float32)
    for b in range(B):
        n_q = int(rng.integers(1, 6)) if by_df else T - 1
        draws = np.concatenate([[0], rng.choice(n_terms, size=n_q, p=probs)])
        uniq, counts = np.unique(draws, return_counts=True)
        tids[b, : len(uniq)] = uniq[:T]
        qtf[b, : len(uniq)] = counts[:T]
    return tids, qtf


def query_strings(rng, dfs, words, B, min_distinct=0):
    """Query texts of 1-5 df-drawn terms; redrawn until the batch (with
    the anchor appended by preprocessing) has > ``min_distinct`` terms."""
    while True:
        tids, qtf = sample_terms(rng, dfs, B, 8)
        qs = [
            " ".join(words[t] for t, c in zip(ti, qi) if t > 0
                     for _ in range(int(c)))
            for ti, qi in zip(tids, qtf)
        ]
        distinct = len({t for row in tids for t in row if t >= 0})
        if distinct > min_distinct:
            return qs


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes, ops, rate):
    t_b, t_o = nbytes / HBM_BPS, ops / rate
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def check_kernels(eng, dfs, rng):
    """Phase 4: each kernel against its plain version on the same tensors."""
    d = eng.didx
    dev = eng.device
    st = d.slot_stream
    views = (d.slot_terms, d.slot_impact)
    # What the scoring function must move: every slot's term id (pad slots
    # included) and the group tables; an impact only where the posting
    # matches a query term (see stream_bytes_for below).
    table_bytes = st.terms.numel() * 4
    table_bytes += st.group_off.numel() * 8 + st.group_rows.numel() * 4
    n_real = int((st.terms >= 0).sum().item())
    rows = {}

    def matched_postings(ids):
        real = ids[ids >= 0]
        return int(torch.isin(st.terms, real).sum().item())

    # kernel 1: B in {1, 16, 64}, T = 8
    err1, k1 = 0.0, None
    for B in (1, 16, 64):
        tids, qtf = sample_terms(rng, dfs, B, 8)
        t = torch.as_tensor(tids, device=dev)
        q = torch.as_tensor(qtf, device=dev)
        got = slots_keyed(st, *views, t, q)
        want = slots_plain(*views, t, q)
        e = (got - want).abs().max().item()
        check(e <= BM25_ATOL, f"bm25_slots B={B}: max err {e}")
        err1 = max(err1, e)
        ms = cuda_ms(lambda: slots_keyed(st, *views, t, q), 20)
        pms = cuda_ms(lambda: slots_plain(*views, t, q), 3, 1)
        matched = matched_postings(t)
        nb = table_bytes + matched * 4 + tids.nbytes + qtf.nbytes
        nb += got.numel() * 4
        b_ms, b_by = bound(nb, n_real * B * (8 + 2), F32_OPS)
        log(f"  bm25_slots B={B} T=8: err {e:.2e} kernel {ms:.4f} ms "
            f"plain {pms:.4f} ms bound {b_ms:.4f} ms ({b_by}; {matched} of "
            f"{n_real} postings matched)")
        if B == 1:  # the engine's plain-kernel branch serves B < 8
            k1 = dict(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by)
    rows["bm25_slots"] = dict(k1, max_abs_err=err1)

    # kernels 2 and 3: U = 128 (df-drawn) and U = 512 (uniform draws)
    cases = [(1, True), (16, True), (64, True), (64, False)]
    for variant, main_b in (("sublane", 16), ("i8", 64)):
        kern = UDEDUP_KERNELS[variant]
        err, main = 0.0, None
        for B, by_df in cases:
            tids, qtf = sample_terms(rng, dfs, B, 8, by_df)
            uids, w = dedup_query_terms(tids, qtf)
            u = torch.as_tensor(uids, device=dev)
            wt = torch.as_tensor(w, device=dev)
            got = slots_udedup_keyed(st, *views, u, wt, variant)
            want = slots_udedup_plain(*views, u, wt, variant)
            e = (got - want).abs().max().item()
            check(e <= BM25_ATOL, f"{kern.name} B={B} U={u.numel()}: err {e}")
            err = max(err, e)
            ms = cuda_ms(
                lambda: slots_udedup_keyed(st, *views, u, wt, variant), 20
            )
            pms = cuda_ms(
                lambda: slots_udedup_plain(*views, u, wt, variant), 3, 1
            )
            matched = matched_postings(u)
            nb = table_bytes + matched * 4 + uids.nbytes + w.nbytes
            nb += got.numel() * 4
            b_ms, b_by = bound(nb, n_real + matched * 2 * B, F32_OPS)
            log(f"  {kern.name} B={B} U={u.numel()}: err {e:.2e} kernel "
                f"{ms:.4f} ms plain {pms:.4f} ms bound {b_ms:.4f} ms ({b_by}; "
                f"{matched} of {n_real} postings matched)")
            if B == main_b and by_df:
                main = dict(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by)
        rows[kern.name] = dict(main, max_abs_err=err)

    # kernel 4: every bucket, B in {1, 16, 64}
    err4 = 0.0
    for B in (1, 16, 64):
        qv = torch.randn(B, d.bucket_emb[0].shape[2], device=dev)
        qv = qv / qv.norm(dim=1, keepdim=True)
        for emb in d.bucket_emb:
            e = stats_max_abs_err(
                bucket_stats(emb, qv), stats_plain(emb, qv),
                bucket_sims(emb, qv),
            )
            check(e <= STATS_ATOL, f"dense_stats B={B} {tuple(emb.shape)}: {e}")
            err4 = max(err4, e)

        def all_buckets(fn):
            return lambda: [fn(emb, qv) for emb in d.bucket_emb]

        def library(emb, q):  # yardstick only: one einsum + torch top-2
            sims = torch.einsum("bd,ncd->bnc", q.to(emb.dtype), emb)
            if emb.shape[0] > 1:
                torch.topk(sims, 2, dim=1)
            return sims.amin(dim=1)

        ms = cuda_ms(all_buckets(bucket_stats), 10)
        pms = cuda_ms(all_buckets(stats_plain), 3, 1)
        lms = cuda_ms(all_buckets(library), 10)
        nb = sum(e.numel() * 2 + 5 * B * e.shape[1] * 4 for e in d.bucket_emb)
        nb += B * qv.shape[1] * 2
        ops = sum(2 * B * e.numel() for e in d.bucket_emb)
        b_ms, b_by = bound(nb, ops, BF16_OPS)
        log(f"  dense_stats B={B} ({len(d.bucket_emb)} buckets): err "
            f"{err4:.2e} kernel {ms:.4f} ms plain {pms:.4f} ms library "
            f"{lms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        if B == 64:
            rows["dense_stats"] = dict(
                ms=ms, plain_ms=pms, library_ms=lms, bound_ms=b_ms,
                bound_by=b_by,
            )
    rows["dense_stats"]["max_abs_err"] = err4
    return rows


def profile_batch(eng, qs):
    """One warm ``search_batch`` under ``torch.profiler``: device busy time
    (the union of the device's kernel, copy and set intervals), the device's
    idle share of the traced span (first to last event, host or device), and
    device time per kernel name.  None when the trace holds no device
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        eng.search_batch(qs, top_k=10)
        torch.cuda.synchronize()
    evs = [e for e in p.events() if e.time_range.end > e.time_range.start]
    dev = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in evs if e.device_type == DeviceType.CUDA
    )
    if not dev:
        return None
    span = (max(e.time_range.end for e in evs)
            - min(e.time_range.start for e in evs))
    busy, end = 0.0, -float("inf")
    for a, b, _ in dev:  # union of intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    per = {}
    for a, b, n in dev:  # "void ns::(anonymous namespace)::k<...>(...)" -> ns::k
        n = n.removeprefix("void ").replace("(anonymous namespace)::", "")
        n = n.split("(")[0].split("<")[0]
        per[n] = per.get(n, 0.0) + (b - a) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return {
        "span_ms": span / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / span,
        "device_events": len(dev),
        "top_device_ms": {k: round(v, 4) for k, v in top},
    }


def same_top(got, want, what):
    """Top lists agree: scores to E2E_ATOL, ids except inside near-ties."""
    check(len(got) == len(want), f"{what}: {len(got)} vs {len(want)} rows")
    for i, (g, w) in enumerate(zip(got, want)):
        check(
            abs(g.similarity_score - w.similarity_score) <= E2E_ATOL,
            f"{what}[{i}]: score {g.similarity_score} vs {w.similarity_score}",
        )
        if g.doc_id != w.doc_id:
            near = [
                abs(want[j].similarity_score - w.similarity_score) <= E2E_ATOL
                for j in (i - 1, i + 1)
                if 0 <= j < len(want)
            ]
            check(any(near), f"{what}[{i}]: doc {g.doc_id} vs {w.doc_id}")
        else:
            check(g.window_index == w.window_index, f"{what}[{i}]: window")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    t0 = time.time()
    cuda_lib.build()
    cuda_lib.load()
    log(f"build: {time.time() - t0:.1f} s")
    for line in cuda_lib.build_log().splitlines():
        if "Used" in line or "spill" in line and "0 bytes spill" not in line:
            log("  ptxas:", line.strip())

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    art, words, dfs = make_artifacts(
        args.seed, n_docs=100_000, n_terms=50_000, nnz_target=8_000_000,
        avg_chunks=3.0, dim=768,
    )
    log(f"index: {art.n_docs} docs, {art.n_chunks} chunks, "
        f"{art.post_docs.size} postings, made in {time.time() - t0:.1f} s")
    cfg = Config()  # the default: slots layout, U-dedup, exact top-k
    enc = HashingEncoder(dim=cfg.embedding_dim)
    t0 = time.time()
    eng = SearchEngine(art, enc, cfg)
    torch.cuda.synchronize()
    d = eng.didx
    log(f"  engine on {eng.device}: built in {time.time() - t0:.1f} s; "
        f"{len(d.slot_terms)} stride classes, {len(d.buckets)} buckets, "
        f"{d.slot_stream.terms.numel() * 8 / 1e6:.1f} MB slot postings, "
        f"{sum(e.numel() * 2 for e in d.bucket_emb) / 1e6:.1f} MB bf16 bank, "
        f"{d.resident_bytes() / 1e6:.1f} MB resident")

    log("kernels vs plain versions:")
    rows = check_kernels(eng, dfs, rng)

    # --- phase 5: the main path through the user's entry point ------------
    batches = {
        1: query_strings(rng, dfs, words, 1),
        16: query_strings(rng, dfs, words, 16),
        64: query_strings(rng, dfs, words, 64, min_distinct=128),
    }
    # each batch is its own path: counts set to 0 just before, read after
    want_bm25 = {1: "bm25_slots", 16: "bm25_slots_udedup_sublane",
                 64: "bm25_slots_udedup_i8"}
    n_buckets = len(d.buckets)
    results, launches = {}, {}
    for B, qs in batches.items():
        for k in cuda_lib.KERNELS:
            k.launches = 0
        results[B] = eng.search_batch(qs, top_k=10)
        launches[B] = {k.name: k.launches for k in cuda_lib.KERNELS}
        log(f"main path B={B} launches: {launches[B]}")
        for k_name, n in launches[B].items():
            want = (1 if k_name == want_bm25[B] else n_buckets
                    if k_name == "dense_stats" else 0)
            check(n == want, f"B={B}: {k_name} launched {n} times, not {want}")
    for B, res in results.items():
        check(len(res) == B and all(len(r) > 0 for r in res), f"B={B}: empty")
        for r in res:
            s = [x.similarity_score for x in r]
            check(np.all(np.isfinite(s)) and s == sorted(s, reverse=True),
                  f"B={B}: scores not finite and descending")

    t0 = time.time()
    cpu = SearchEngine(art, enc, cfg, bank_dtype=torch.bfloat16, device="cpu")
    for B in (1, 16):
        want = cpu.search_batch(batches[B], top_k=10)
        for i, (g, w) in enumerate(zip(results[B], want)):
            same_top(g, w, f"card vs cpu B={B} q{i}")
    log(f"  card == cpu engine on the B=1 and B=16 batches "
        f"({time.time() - t0:.1f} s)")
    # numpy oracle on the same bf16-rounded bank and query
    bf = dataclasses.replace(
        art,
        chunk_emb=torch.from_numpy(art.chunk_emb).bfloat16().float().numpy(),
    )
    for i, q in enumerate(batches[16][:3]):
        pq = preprocess_query(q)
        qe = torch.from_numpy(enc.encode(pq)).bfloat16().float().numpy()
        ref = hybrid_search_numpy(
            bf, pq, qe, cfg.top_k_retrieval, 10, cfg.smoothing,
            diversification=cfg.diversification,
        )
        same_top(results[16][i], ref, f"card vs numpy oracle q{i}")
    log("  card == numpy oracle on 3 queries")

    for B, qs in batches.items():
        eng.times = StageTimes()
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            eng.search_batch(qs, top_k=10)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        p50 = float(np.median(ts))
        host = {k: v["mean_ms"] for k, v in eng.times.report().items()}
        log(f"  search_batch B={B}: p50 {p50 * 1e3:.3f} ms, "
            f"{B / p50:.1f} queries/s on {name} ({smi}); host stage means "
            f"(ms): {host}")
        prof = profile_batch(eng, qs)
        if prof is None:
            log(f"    torch.profiler, B={B}: no device events in the trace, "
                "device time not measured")
        else:  # the profiler slows the host, so also hold busy time to p50
            prof["idle_share_of_p50"] = 1.0 - prof["device_busy_ms"] / (p50 * 1e3)
            log(f"    torch.profiler, one search_batch B={B}: {json.dumps(prof)}")

    out = []
    for k in cuda_lib.KERNELS:
        r = rows[k.name]
        out.append({
            "name": k.name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": sum(launches[B][k.name] for B in batches),
            "launches_per_batch": {B: launches[B][k.name] for B in batches},
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
        })
    log(json.dumps({"kernels": out}))
    log(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name,
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
