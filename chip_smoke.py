#!/usr/bin/env python3
"""Drive the torch port of the hybrid search engine on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the repository root.  It needs a CUDA device and exits non-zero,
printing no result, without one.  Phases (each failure ends the run with a
non-zero exit):

  1. device: the card's name and power limit;
  2. build: one nvcc -c per csrc/*.cu, all started together, then one
     link (seconds are printed);
  3. index: synthetic IndexArtifacts in the shape of the repository's
     bench corpus (100k docs, 50k-term Zipf(0.7) vocabulary, ~80 postings
     per doc with gamma(2, 1.5) impacts, 1 + Poisson(2) chunks per doc
     capped at 10, unit-norm 768-d chunk vectors), made from --seed, and
     the port's SearchEngine built over it on the card twice: the default
     slot layout and ``bm25_layout="blocked"``;
  4. kernels: every kernel of both paths against its plain PyTorch
     version on the same tensors at the path's shapes, with times (CUDA
     events; kernels and library calls queued behind a sleep kernel, so
     the host's enqueue is not counted); kernel 4 also beside one einsum +
     top-2 and beside the bank product alone; the blocked kernels' scores
     also against the slot kernels', bit for bit (kernel 7 against kernel
     1, kernel 8 against kernel 2 on the same ids and weights);
     the U-dedup kernels 2, 3, 5 ("acc") and 6 ("wide", "wide_i8") at
     B = 16 / U = 128, B = 64 / U = 256 and B = 64 / U = 512, kernel 6
     also bit for bit against kernels 2 and 3, with the tensor-core work
     its schedule implies (``wide_mma_count``, a host-side count) in the
     log;
  5. end to end, each path in turn: SearchEngine.search_batch on batches
     of 1, 16 and 64 queries for the slot path and of 1, 64 sharing few
     terms and 64 with many for the blocked path (one per BM25 dispatch
     branch), the launch counters set to 0 before each batch and read
     after it (exactly that branch's BM25 kernel once, the stats kernel
     once per bucket); then this slice's paths, each with the counters
     set to 0 before it and read after: ``ops.hybrid_rank_slots_udedup``
     with no ``variant`` (the legacy default, kernel 5 once) at B = 16 and
     64, held against variant="sublane" and the numpy oracle, and the
     U-dedup A/B bench (``bench_kernels.gate_fit``: 8 (B, U) cells x 5
     variants, each held against kernel 2, kernel 6 bit for bit, with the
     gate's agreement);
     the slot results held against the port's own
     engine on the CPU and the numpy oracle, the blocked results against
     the slot engine and the numpy oracle; then queries/s, p50 latency and
     one torch.profiler trace per batch (device busy time, idle share,
     device time per kernel);
  5b. the bi-encoder at full width (12 layers, 768 wide; weights drawn
     from --seed, no checkpoint read): the card's forward against the
     port's on the CPU at (B, L) = (1, 16), (16, 16), (64, 16), (1, 512);
     device ms of one forward beside its bound; search_batch with it on
     the 100k index at B = 1, 16, 64 (launches checked as in 5, no host
     sync from encode to rank, top-10 against the numpy oracle fed the
     card's query vectors, timings as in 5); a 2,000-doc index embedded
     by it on the card (chunks/s), served and checked the same way;
  6. small phases: an empty index (served by the blocked kernel, every
     entry point returns []); U = 1152 distinct terms and T = 80 term
     slots on every BM25 kernel (kernels 1-3 and 5-8) against its plain
     version;
     approx_candidates=True equal to the exact engine;
  7. a {"kernels": [...]} JSON line (time, bound, plain time, error per kernel),
     the nvidia-smi line, and the final {"ok": true, ...} line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from modern_search_engines_project_tpu_torch import bench_kernels
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import Document, IndexBuilder
from modern_search_engines_project_tpu_torch.kernel_times import device_ms
from modern_search_engines_project_tpu_torch.models import (
    EncoderConfig,
    HashingEncoder,
    TorchEncoder,
    init_reference_params,
)
from modern_search_engines_project_tpu_torch.retrieval import cuda_lib, ops
from modern_search_engines_project_tpu_torch.retrieval.bm25_blocked import (
    BLOCKED_KERNEL,
    blocked_plain,
    blocked_udedup_gate,
    blocked_udedup_plain,
    bm25_score_blocked,
    bm25_score_blocked_udedup,
)
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    UDEDUP_KERNELS,
    _slots_key,
    bm25_score_slots,
    dedup_query_terms,
    slots_keyed,
    slots_plain,
    slots_udedup_keyed,
    slots_udedup_plain,
    u_pad_for,
)
from modern_search_engines_project_tpu_torch.retrieval.dense_stats import (
    bucket_sims,
    bucket_stats,
    stats_max_abs_err,
    stats_plain,
)
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    SLOT_COLS,
    build_blocked_postings,
    build_slot_postings,
    pack_blocked,
    pack_slot_classes,
)
from modern_search_engines_project_tpu_torch.retrieval.engine import SearchEngine
from modern_search_engines_project_tpu_torch.retrieval.numpy_ref import (
    hybrid_search_numpy,
    preprocess_query,
)
from modern_search_engines_project_tpu_torch.synthetic import (
    make_artifacts,
    query_strings,
    sample_terms,
)
from modern_search_engines_project_tpu_torch.utils.timing import StageTimes

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 on
# the CUDA cores, bf16 on the tensor cores.
HBM_BPS = 3.35e12
F32_OPS = 67e12
BF16_OPS = 989e12
INT8_OPS = 1979e12

# Tolerances.  BM25: every kernel sums at most T nonzero f32 products per
# doc, in another order than its plain version -> keyed scores to 1e-5.
# Stats: kernel and plain version read the same bf16 bank and query and
# sum 768 f32 products in different orders (~1e-6); 1e-4 leaves room.
BM25_ATOL = 1e-5
STATS_ATOL = 1e-4
# U = 1152 / T = 80: with 77 terms a query a doc sums up to 77 matched
# products and scores reach ~100, where one f32 ulp is 7.6e-6; sums taken
# in another order differ by a few ulps -> rtol 1e-6 beside atol 1e-5.
# Kernel 5 ("acc") sums a 3-way bf16 split in another order than its plain
# version at every shape, so it is held to the same rtol.
WIDE_RTOL = 1e-6
# End to end: the card's engine and the CPU engine (same bf16 bank) differ
# only in summation order inside the stats and the f32 fusion arithmetic;
# after min-max normalization that stays far below 1e-3.  Ids must match
# except where neighbouring fused scores lie within 1e-3 of each other.
E2E_ATOL = 1e-3
# The bi-encoder: the card and the CPU run the same bf16 arithmetic with
# products reduced in other orders; bf16 roundings that differ by an ulp
# compound over 12 layers -> unit embeddings to 5e-3, cosine 0.9999.
ENC_ATOL = 5e-3
ENC_COS = 0.9999


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps, warmup=2):
    """Time of one ``fn()`` in ms, host enqueue included (CUDA events
    around ``reps`` calls): for the plain versions, which may wait on the
    host.  Kernels and library calls are timed with ``device_ms``."""
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


def wide_mma_count(stream, uids, B: int, variant: str) -> int:
    """``mma.sync`` instructions that kernel 6's schedule ("wide" or
    "wide_i8") implies for B queries of distinct ids ``uids`` on the slot
    stream ``stream``, each 2 x 16 x 8 x k operations: a host-side count
    from the matches, not a device counter.  In every 16-row stage of a
    group and tile of 8 columns, step j takes the j-th matched row of each
    column and multiplies once for every k block of the ids (k = 16 in
    bf16, 32 in int8) that one of those matches falls in, for each m16
    tile of the queries: ceil(B / 16) over the query chunks."""
    k = 32 if variant == "wide_i8" else 16
    terms = stream.terms
    real = torch.nonzero(uids >= 0).squeeze(1)
    if real.numel() == 0:
        return 0
    ids, order = torch.sort(uids[real])
    at = torch.searchsorted(ids, terms).clamp(max=ids.numel() - 1)
    i = torch.nonzero(ids[at] == terms).squeeze(1)  # matched slots
    u = real[order[at[i]]]  # their positions in uids
    g = torch.searchsorted(stream.group_off, i, right=True) - 1
    row = (i - stream.group_off[g]) // SLOT_COLS
    col = g * SLOT_COLS + i % SLOT_COLS  # the column's output index
    n_stages = int(stream.group_rows.max()) // 16 + 1
    # (column, stage) segments in row order; j = a match's rank in its segment
    seg, perm = torch.sort(col * n_stages + row // 16, stable=True)
    first = torch.ones_like(seg, dtype=torch.bool)
    first[1:] = seg[1:] != seg[:-1]
    n = torch.arange(seg.numel(), device=seg.device)
    j = n - torch.cummax(torch.where(first, n, 0), 0).values
    tile_stage = (col // 8 * n_stages + row // 16)[perm]
    kb = u[perm] // k
    key = (tile_stage * 16 + j) * (-(-uids.numel() // k)) + kb
    return int(torch.unique(key).numel()) * -(-B // 16)


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
    table_bytes += st.group_order.numel() * 4
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
        ms = device_ms(lambda: slots_keyed(st, *views, t, q), 20)
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

    # kernels 2 and 3 (id lookup), 5 and 6 (tensor-core products): U = 128
    # and 256 (df-drawn, B = 16 and 64) and U = 512 (uniform draws).  All
    # five share the bound of kernels 2-3.  Kernel 6 equals kernels 2-3 bit
    # for bit; kernel 5 ("acc") sums a 3-way bf16 split in another order,
    # so it is held to WIDE_RTOL beside BM25_ATOL.
    cases = [(1, True), (16, True), (64, True), (64, False)]
    same_as = {"wide": "sublane", "wide_i8": "i8"}
    for variant, main_b in (("sublane", 16), ("i8", 64), ("acc", 64),
                            ("wide", 64), ("wide_i8", 64)):
        kern = UDEDUP_KERNELS[variant]
        rtol = WIDE_RTOL if variant == "acc" else 0.0
        err, main, by_batch = 0.0, None, {}
        for B, by_df in cases:
            tids, qtf = sample_terms(rng, dfs, B, 8, by_df)
            uids, w = dedup_query_terms(tids, qtf)
            u = torch.as_tensor(uids, device=dev)
            wt = torch.as_tensor(w, device=dev)
            got = slots_udedup_keyed(st, *views, u, wt, variant)
            want = slots_udedup_plain(*views, u, wt, variant)
            e = (got - want).abs().max().item()
            excess = ((got - want).abs() - rtol * want.abs()).max().item()
            check(excess <= BM25_ATOL and torch.equal(got < 0, want < 0),
                  f"{kern.name} B={B} U={u.numel()}: err {e}")
            if variant in same_as:
                check(torch.equal(got, slots_udedup_keyed(
                    st, *views, u, wt, same_as[variant])),
                    f"{kern.name} B={B}: not equal to {same_as[variant]}")
            err = max(err, e)
            ms = device_ms(
                lambda: slots_udedup_keyed(st, *views, u, wt, variant), 20
            )
            pms = cuda_ms(
                lambda: slots_udedup_plain(*views, u, wt, variant), 3, 1
            )
            matched = matched_postings(u)
            nb = table_bytes + matched * 4 + uids.nbytes + w.nbytes
            nb += got.numel() * 4
            b_ms, b_by = bound(nb, n_real + matched * 2 * B, F32_OPS)
            Bp, Up = -(-B // 16) * 16, -(-u.numel() // 128) * 128
            extra = {}
            log_ops = ""
            if variant == "acc":  # four products a doc column
                log_ops = (f"; tensor-core product "
                           f"{8 * Bp * Up * st.n_cols:.3e} operations")
            if variant in ("wide", "wide_i8"):
                peak = INT8_OPS if variant == "wide_i8" else BF16_OPS
                k = 32 if variant == "wide_i8" else 16
                # the TPU formulation: its dense 0/1 match-tile product over
                # every slot, (B, U) @ (U, 8 * COLS), at the same peak
                extra["tpu_formulation_bound_ms"] = (
                    2 * Bp * Up * st.terms.numel() / peak * 1e3)
                # the products kernel 6's schedule implies (counted on the
                # host, not measured): an m16n8k mma.sync per m16 tile of
                # the queries for each (step, k block) holding a match
                n_mma = wide_mma_count(st, u, B, variant)
                log_ops = (f"; its schedule's tensor-core work {n_mma} "
                           f"mma.sync, {n_mma * 2 * 16 * 8 * k:.3e} "
                           f"operations (host count)")
            log(f"  {kern.name} B={B} U={u.numel()}: err {e:.2e} kernel "
                f"{ms:.4f} ms plain {pms:.4f} ms bound {b_ms:.4f} ms ({b_by}; "
                f"{matched} of {n_real} postings matched){log_ops}")
            if by_df:
                by_batch[f"B={B} U={u.numel()}"] = dict(
                    ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, **extra)
            if B == main_b and by_df:
                main = dict(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                            **extra)
        rows[kern.name] = dict(main, max_abs_err=err, by_batch=by_batch)

    # kernel 4: every bucket, B in {1, 16, 64}
    err4, by_batch = 0.0, {}
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

        def product(emb, q):  # yardstick only: the bf16 bank product alone
            return torch.matmul(q.to(emb.dtype), emb.view(-1, emb.shape[2]).t())

        ms = device_ms(all_buckets(bucket_stats), 10)
        pms = cuda_ms(all_buckets(stats_plain), 3, 1)
        lms = device_ms(all_buckets(library), 10)
        mms = device_ms(all_buckets(product), 10)
        nb = sum(e.numel() * 2 + 5 * B * e.shape[1] * 4 for e in d.bucket_emb)
        nb += B * qv.shape[1] * 2
        ops = sum(2 * B * e.numel() for e in d.bucket_emb)
        b_ms, b_by = bound(nb, ops, BF16_OPS)
        log(f"  dense_stats B={B} ({len(d.bucket_emb)} buckets): err "
            f"{err4:.2e} kernel {ms:.4f} ms plain {pms:.4f} ms library "
            f"(einsum + top-2) {lms:.4f} ms bank product alone {mms:.4f} ms "
            f"bound {b_ms:.4f} ms ({b_by})")
        by_batch[f"B={B}"] = dict(
            ms=ms, plain_ms=pms, library_ms=lms, library_matmul_ms=mms,
            bound_ms=b_ms, bound_by=b_by,
        )
    rows["dense_stats"] = dict(by_batch["B=64"], max_abs_err=err4,
                               by_batch=by_batch)
    return rows


def legacy_default(eng, rng, dfs, words, cfg, enc, art):
    """``ops.hybrid_rank_slots_udedup`` with no ``variant``: the legacy
    default picks "acc" (kernel 5), as in the reference.  At B = 16 and 64
    the counters are set to 0 before the call and read after: kernel 5
    once, kernels 2-3 never, the stats kernel once per bucket.  The top-10
    (through ``finish_batch``) equals variant="sublane"'s and, on three
    queries, the numpy oracle's, outside near-ties.  Returns the launch
    counts per batch."""
    n_buckets = len(eng.didx.buckets)
    kw = dict(k_ret=eng.k_ret, smoothing=eng.cfg.smoothing,
              approx=eng._approx)
    launches = {}
    for B in (16, 64):
        qs = query_strings(rng, dfs, words, B)
        tids, qtf, processed = eng.prepare_queries(qs)
        uids, w = dedup_query_terms(tids, qtf)
        u = torch.as_tensor(uids, device=eng.device)
        wt = torch.as_tensor(w, device=eng.device)
        qv = torch.as_tensor(eng.encode_queries(processed), device=eng.device)
        for k in cuda_lib.KERNELS:
            k.launches = 0
        outs = ops.hybrid_rank_slots_udedup(eng.didx, u, wt, qv, **kw)
        counts = {k.name: k.launches for k in cuda_lib.KERNELS}
        launches[f"B={B}"] = counts
        log(f"legacy default B={B} U={uids.size} launches: {counts}")
        for k_name, n in counts.items():
            want = (1 if k_name == "bm25_slots_udedup_acc" else n_buckets
                    if k_name == "dense_stats" else 0)
            check(n == want, f"legacy default B={B}: {k_name} launched {n} "
                  f"times, not {want}")
        got = eng.finish_batch(eng._to_host(outs), qs, 10)
        ref = eng.finish_batch(eng._to_host(ops.hybrid_rank_slots_udedup(
            eng.didx, u, wt, qv, variant="sublane", **kw)), qs, 10)
        for i, (g, r) in enumerate(zip(got, ref)):
            check(len(g) > 0, f"legacy default B={B} q{i}: empty")
            same_top(g, r, f"legacy default vs sublane B={B} q{i}")
        same_as_oracle(art, enc, cfg, got, qs[:3], f"legacy default B={B}")
        log(f"  legacy default B={B}: top-10 == variant='sublane' on every "
            "query, == numpy oracle on 3")
    return launches


def bench_phase(eng, dfs):
    """The U-dedup A/B bench (``bench_kernels.gate_fit``) in-process on the
    slot engine's index: every (B, U) cell and variant timed, each
    variant held against kernel 2.  Returns the launch counts of the
    run."""
    for k in cuda_lib.KERNELS:
        k.launches = 0
    t0 = time.time()
    rows, gate, par = bench_kernels.gate_fit(eng.didx, dfs)
    counts = {k.name: k.launches for k in cuda_lib.KERNELS}
    n_ok = sum(c["agree"] for c in gate.values())
    for cell, p in par.items():  # kernel 6's products are exact
        check(p["wide"]["bit_identical"] and p["wide_i8"]["bit_identical"],
              f"gate fit {cell}: kernel 6 not equal to kernel 2")
    check(len(gate) == 8 and all(
        all(isinstance(c[v], float) for v in ("plain", *bench_kernels.VARIANTS))
        for c in gate.values()), "gate fit: a cell is missing")
    log(f"bench gate_fit ({time.time() - t0:.1f} s; launches {counts}):")
    log(f"  raw ms per call: {json.dumps(rows)}")
    for cell, c in gate.items():
        ident = [v for v, r in par[cell].items() if r["bit_identical"]]
        err = max(r["max_abs_err"] for r in par[cell].values())
        log(f"  {cell}: " + " ".join(
            f"{k} {c[k]:.4f}" for k in ("plain", *bench_kernels.VARIANTS))
            + f" | winner {c['measured_winner']} gate {c['gate_pick']} "
            f"agree {c['agree']} | bit-identical to kernel 2: {ident}, "
            f"max abs diff {err:.2e}")
    log(f"gate agreement: {n_ok}/{len(gate)} cells (pick within 10% + "
        "0.05 ms of the measured winner)")
    return {"gate_fit": counts}


def to_artifact_order(keyed, doc_perm, n_docs):
    """Keyed scores [B, n_docs_pad + 1] in an engine's permuted doc order ->
    [B, n_docs] in artifact order (so two layouts can be compared)."""
    real = np.nonzero(doc_perm >= 0)[0]
    out = torch.empty(keyed.shape[0], n_docs, device=keyed.device)
    out[:, torch.as_tensor(doc_perm[real], device=keyed.device)] = keyed[
        :, torch.as_tensor(real, device=keyed.device)
    ]
    return out


def check_blocked_kernels(eng_b, eng_s, dfs, rng):
    """Phase 4, blocked path: kernels 7 and 8 against their plain versions
    on the blocked engine's tensors; kernel 7 also against slot kernel 1
    and kernel 8 against slot kernel 2 on the slot engine (both mapped to
    artifact doc order), bit for bit."""
    d = eng_b.didx
    blk = d.blocked
    dev = eng_b.device
    # What the scoring function must move: the 4-byte term id of every real
    # posting (a row's pads, from doc_off[i, 128] on, are never read), the
    # per-row doc offsets (129 int32 a row, in place of a local id per
    # slot), a 4-byte impact per matched posting, queries, keyed output.
    n_real = int(blk.doc_off[:, -1].sum().item())
    base_bytes = n_real * 4 + blk.doc_off.numel() * 4
    rows = {}

    def matched_postings(ids):
        return int(torch.isin(blk.terms, ids[ids >= 0]).sum().item())

    err, by_batch = 0.0, {}
    for B in (1, 16, 64):
        tids, qtf = sample_terms(rng, dfs, B, 8)
        t = torch.as_tensor(tids, device=dev)
        q = torch.as_tensor(qtf, device=dev)
        got = bm25_score_blocked(blk, t, q)
        want = blocked_plain(blk, t, q)
        e = (got - want).abs().max().item()
        check(e <= BM25_ATOL, f"bm25_blocked B={B}: max err {e}")
        check(torch.equal(got < 0, want < 0), f"bm25_blocked B={B}: keys")
        err = max(err, e)
        ms = device_ms(lambda: bm25_score_blocked(blk, t, q), 20)
        pms = cuda_ms(lambda: blocked_plain(blk, t, q), 3, 1)
        matched = matched_postings(t)
        nb = base_bytes + matched * 4 + tids.nbytes + qtf.nbytes
        nb += got.numel() * 4
        # the function's least work: one lookup per real posting, a
        # multiply-add and a compare per query for each matched posting
        # (as kernel 8's bound counts); the first design's bound counted
        # its B x T compares per posting, kept beside it
        b_ms, b_by = bound(nb, n_real + matched * 2 * B, F32_OPS)
        old_ms, old_by = bound(nb, n_real * B * (8 + 2), F32_OPS)
        log(f"  bm25_blocked B={B} T=8: err {e:.2e} kernel {ms:.4f} ms "
            f"plain {pms:.4f} ms bound {b_ms:.4f} ms ({b_by}); compare-count "
            f"bound {old_ms:.4f} ms ({old_by}); {matched} of {n_real} "
            "postings matched")
        if B == 16:
            slot = bm25_score_slots(eng_s.didx, t, q)
            n = eng_b.art.n_docs
            a = to_artifact_order(got, d.doc_perm, n)
            b = to_artifact_order(slot, eng_s.didx.doc_perm, n)
            check(torch.equal(a, b),
                  "bm25_blocked vs bm25_slots B=16: not equal bit for bit")
            log("  bm25_blocked == bm25_slots at B=16 in artifact doc "
                "order, bit for bit")
        by_batch[f"B={B}"] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                                  bound_by=b_by, bound_old_ms=old_ms)
    # the engine's kernel-7 branch: every B = 1 batch
    rows["bm25_blocked"] = dict(by_batch["B=1"], max_abs_err=err,
                                by_batch=by_batch)

    err, main, by_batch = 0.0, None, {}
    for B, pool in ((1, None), (16, None), (64, None), (64, 100)):
        tids, qtf = sample_terms(rng, dfs, B, 8, pool=pool)
        uids, w = dedup_query_terms(tids, qtf)
        u = torch.as_tensor(uids, device=dev)
        wt = torch.as_tensor(w, device=dev)
        got = bm25_score_blocked_udedup(blk, u, wt)
        want = blocked_udedup_plain(blk, u, wt)
        e = (got - want).abs().max().item()
        check(e <= BM25_ATOL, f"bm25_blocked_udedup B={B} U={u.numel()}: {e}")
        check(torch.equal(got < 0, want < 0), f"bm25_blocked_udedup B={B}")
        err = max(err, e)
        ms = device_ms(lambda: bm25_score_blocked_udedup(blk, u, wt), 20)
        pms = cuda_ms(lambda: blocked_udedup_plain(blk, u, wt), 3, 1)
        matched = matched_postings(u)
        nb = base_bytes + matched * 4 + uids.nbytes + w.nbytes
        nb += got.numel() * 4
        b_ms, b_by = bound(nb, n_real + matched * 2 * B, F32_OPS)
        log(f"  bm25_blocked_udedup B={B} U={u.numel()}: err {e:.2e} kernel "
            f"{ms:.4f} ms plain {pms:.4f} ms bound {b_ms:.4f} ms ({b_by}; "
            f"{matched} of {n_real} postings matched)")
        if B == 64:
            # kernel 8 sums each doc's matched bf16(w) * impact in posting
            # order, as slot kernel 2 sums its rows: equal bit for bit
            slot = slots_udedup_keyed(eng_s.didx.slot_stream,
                                      eng_s.didx.slot_terms,
                                      eng_s.didx.slot_impact, u, wt, "sublane")
            n = eng_b.art.n_docs
            a = to_artifact_order(got, d.doc_perm, n)
            b = to_artifact_order(_slots_key(slot, eng_s.didx.col_unperm, B),
                                  eng_s.didx.doc_perm, n)
            check(torch.equal(a, b), f"bm25_blocked_udedup vs "
                  f"bm25_slots_udedup_sublane B=64 U={u.numel()}: not equal")
            log(f"  bm25_blocked_udedup == bm25_slots_udedup_sublane at B=64 "
                f"U={u.numel()} in artifact doc order, bit for bit")
        by_batch[f"B={B}{' shared' if pool else ''} U={u.numel()}"] = dict(
            ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by)
        if pool:  # the engine's kernel-8 branch: B = 64 sharing terms
            main = dict(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by)
    rows["bm25_blocked_udedup"] = dict(main, max_abs_err=err, by_batch=by_batch)
    return rows


def shared_batch(rng, dfs, words, B=64, pool=100):
    """B queries of 2-5 terms from the ``pool`` most frequent terms (the
    anchor aside): at most pool + 1 distinct terms, so the U-dedup bucket
    is 128; the first query has 5, so the term axis buckets to 8."""
    top = np.argsort(-dfs[1:], kind="stable")[:pool] + 1  # term 0: anchor
    qs = []
    for b in range(B):
        n = 5 if b == 0 else int(rng.integers(2, 6))
        qs.append(" ".join(words[t] for t in rng.choice(top, n, replace=False)))
    return qs


def drive(eng, batches, want_bm25, label):
    """Each batch through ``search_batch`` as its own path: every launch
    counter set to 0 just before, read just after; the batch's BM25 kernel
    must have launched once, the stats kernel once per bucket, nothing
    else.  Returns (results, launches) keyed like ``batches``."""
    n_buckets = len(eng.didx.buckets)
    results, launches = {}, {}
    for key, qs in batches.items():
        for k in cuda_lib.KERNELS:
            k.launches = 0
        results[key] = eng.search_batch(qs, top_k=10)
        launches[key] = {k.name: k.launches for k in cuda_lib.KERNELS}
        log(f"main path {label} {key} launches: {launches[key]}")
        for k_name, n in launches[key].items():
            want = (1 if k_name == want_bm25[key] else n_buckets
                    if k_name == "dense_stats" else 0)
            check(n == want,
                  f"{label} {key}: {k_name} launched {n} times, not {want}")
    for key, res in results.items():
        qs = batches[key]
        check(len(res) == len(qs) and all(len(r) > 0 for r in res),
              f"{label} {key}: empty")
        for r in res:
            sc = [x.similarity_score for x in r]
            check(np.all(np.isfinite(sc)) and sc == sorted(sc, reverse=True),
                  f"{label} {key}: scores not finite and descending")
    return results, launches


def same_as_oracle(art, enc, cfg, results, queries, what, qvecs=None):
    """Top-10 against the numpy oracle on the same bf16-rounded bank and
    query; the query vectors are ``enc.encode`` of each processed query,
    or ``qvecs`` (the engine's own, one row a query) where given."""
    bf = dataclasses.replace(
        art,
        chunk_emb=torch.from_numpy(art.chunk_emb).bfloat16().float().numpy(),
    )
    for i, q in enumerate(queries):
        pq = preprocess_query(q)
        qe = enc.encode(pq) if qvecs is None else qvecs[i]
        qe = torch.from_numpy(qe).bfloat16().float().numpy()
        ref = hybrid_search_numpy(
            bf, pq, qe, cfg.top_k_retrieval, 10, cfg.smoothing,
            diversification=cfg.diversification,
        )
        same_top(results[i], ref, f"{what} vs numpy oracle q{i}")


def time_path(eng, batches, label, name, smi):
    """p50 and queries/s of each batch over 10 calls, host stage means, and
    one torch.profiler trace of one warm call."""
    for key, qs in batches.items():
        B = len(qs)
        eng.times = StageTimes()
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            eng.search_batch(qs, top_k=10)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        p50 = float(np.median(ts))
        host = {k: v["mean_ms"] for k, v in eng.times.report().items()}
        log(f"  {label} search_batch {key}: p50 {p50 * 1e3:.3f} ms, "
            f"{B / p50:.1f} queries/s on {name} ({smi}); host stage means "
            f"(ms): {host}")
        prof = profile_call(lambda: eng.search_batch(qs, top_k=10))
        if prof is None:
            log(f"    torch.profiler, {label} {key}: no device events in the "
                "trace, device time not measured")
        else:  # the profiler slows the host, so also hold busy time to p50
            prof["idle_share_of_p50"] = 1.0 - prof["device_busy_ms"] / (p50 * 1e3)
            log(f"    torch.profiler, one {label} search_batch {key}: "
                f"{json.dumps(prof)}")


def check_empty_index(cfg, enc):
    """An empty corpus: no buckets, so the blocked kernel scores one row of
    pads; every entry point returns []."""
    eng = SearchEngine(IndexBuilder(enc, cfg).build([]), enc, cfg)
    check(eng.didx.bm25_layout == "blocked" and not eng.didx.buckets,
          "empty index: not on the blocked fallback")
    for k in cuda_lib.KERNELS:
        k.launches = 0
    res = eng.search("castle", top_k=5)
    counts = {k.name: k.launches for k in cuda_lib.KERNELS}
    check(res == [], f"empty index: search returned {res}")
    check(counts == {k.name: int(k is BLOCKED_KERNEL) for k in cuda_lib.KERNELS},
          f"empty index: launches {counts}")
    check(eng.bm25_search("castle") == [] and eng.dense_search("castle") == [],
          "empty index: bm25_search / dense_search not empty")
    log(f"empty index: search, bm25_search, dense_search returned []; "
        f"launches of search: {counts}")


def check_wide_batches(seed, dev):
    """U = 1152 distinct terms (above the kernels' shared-memory uid table
    of 1024) and T = 80 term slots (above the shared query table of 64) on
    kernels 1-3, 5-6 and 7-8, against their plain versions, on a 12k-doc index
    (the plain versions' time grows with B x T).  Each kernel is also timed
    there and on the same queries cut to T = 64 (61 terms, U <= 1024),
    which take the shared-memory tables of kernels 1-3, 5-6 and 8; kernel 7
    keeps a chunk's table in shared memory only up to 1024 term slots
    (17 x 64 is more), so both of its cases build device-memory tables."""
    art, _, _ = make_artifacts(seed, n_docs=12_000, n_terms=3_000,
                               nnz_target=300_000, avg_chunks=2.0, dim=32)
    csr = (np.asarray(art.indptr), np.asarray(art.post_docs),
           np.asarray(art.post_impact), 12_032)
    vt, vi, stream = pack_slot_classes(*build_slot_postings(*csr)[:2], dev)
    blk = pack_blocked(*build_blocked_postings(*csr), dev)
    rng = np.random.default_rng(11)
    tids = np.stack(
        [rng.choice(np.arange(1, 3_000), 80, replace=False) for _ in range(17)]
    ).astype(np.int32)
    tids[:, -3:] = -1
    qtf = np.where(tids >= 0, rng.integers(1, 4, tids.shape), 0).astype(
        np.float32
    )
    narrow = np.concatenate([tids[:, :61], np.full((17, 3), -1, np.int32)], 1)

    def cases(tids):
        q = np.where(tids >= 0, qtf[:, : tids.shape[1]], 0).astype(np.float32)
        uids, w = dedup_query_terms(tids, q)
        t, q, u, wt = (torch.as_tensor(x, device=dev)
                       for x in (tids, q, uids, w))
        out = {
            "bm25_slots": (lambda: slots_keyed(stream, vt, vi, t, q),
                           lambda: slots_plain(vt, vi, t, q)),
            "bm25_blocked": (lambda: bm25_score_blocked(blk, t, q),
                             lambda: blocked_plain(blk, t, q)),
            "bm25_blocked_udedup": (
                lambda: bm25_score_blocked_udedup(blk, u, wt),
                lambda: blocked_udedup_plain(blk, u, wt),
            ),
        }
        for v in UDEDUP_KERNELS:
            out[UDEDUP_KERNELS[v].name] = (
                lambda v=v: slots_udedup_keyed(stream, vt, vi, u, wt, v),
                lambda v=v: slots_udedup_plain(vt, vi, u, wt, v),
            )
        return uids.size, int((uids >= 0).sum()), out

    n_u, n_real_u, wide = cases(tids)
    check(n_u == 1152 and n_real_u > 1024, f"wide batch: U = {n_u}")
    n_u64, _, small = cases(narrow)
    check(n_u64 <= 1024, f"T=64 batch: U = {n_u64} takes no shared table")
    errs, ms = {}, {}
    for k_name, (kern, plain) in wide.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        excess = ((got - want).abs() - WIDE_RTOL * want.abs()).max().item()
        check(excess <= BM25_ATOL and torch.equal(got < 0, want < 0),
              f"{k_name} at U=1152, T=80: off its plain version")
        check((want >= 0).any().item(), f"{k_name}: nothing matched")
        errs[k_name] = (got - want).abs().max().item()
        ms[k_name] = {"T=80 U=1152 (device-memory tables)": device_ms(kern, 20),
                      f"T=64 U={n_u64}":
                          device_ms(small[k_name][0], 20)}
    log(f"U=1152 (T=80) against the plain versions, max abs err: {errs}")
    log(f"wide batches, 17 queries on 12,000 docs, kernel ms: {json.dumps(ms)}")


def profile_call(fn):
    """One warm ``fn()`` under ``torch.profiler``: device busy time (the
    union of the device's kernel, copy and set intervals), the device's
    idle share of the traced span (first to last event, host or device),
    and device time per kernel name.  None when the trace holds no device
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
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


def encoder_bound(cfg, B, L):
    """Least time of one forward of ``cfg`` on B x L tokens: the bf16
    weights outside the embedding read once, the B x L embedding rows
    gathered, ids and mask in, f32 embeddings out; the products' operations
    (2 a weight a token, plus the two attention products, 2 x L^2 x dim a
    sequence and layer each) at the bf16 tensor-core peak.  Also returns
    the attention products' operations, which the port runs in f32."""
    D, Hd = cfg.dim, cfg.dim * cfg.mlp_ratio
    w = cfg.n_layers * (3 * D * D + D * D + 2 * Hd * D + Hd * D)
    nbytes = w * 2 + B * L * D * 2 + B * L * 8 + B * D * 4
    att = 4 * B * L * L * D * cfg.n_layers
    ms, by = bound(nbytes, 2 * w * B * L + att, BF16_OPS)
    return ms, by, att


def check_sync_free(fn, what):
    """Run ``fn()`` with CUDA's sync debug mode at "error": any call that
    makes the host wait for the device raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    except RuntimeError as e:
        raise RuntimeError(f"{what}: synchronised with the host ({e})") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"  {what}: no host sync (sync debug mode 'error')")
    return out


def encoder_phase(seed, art, words, dfs, cfg, slot_batches, name, smi,
                  enc_cfg=None, n_docs=2_000):
    """The trained bi-encoder's path at full width (``EncoderConfig()``:
    12 layers, 768 wide, 50,257 ids) with weights drawn from ``seed``
    (nothing read from a checkpoint):
      (a) the reference-form tree carried to the card by
          ``params_from_reference`` (through ``TorchEncoder``);
      (b) the card's forward against the port's forward on the CPU on the
          same weights, (B, L) = (1, 16), (16, 16), (64, 16), (1, 512);
      (c) device ms of one forward at five shapes beside its bound, and the
          host's enqueue time and device operations of one forward;
      (d) ``search_batch`` with the encoder on the 100k index at B = 1, 16
          and 64 (each batch's launches checked as in phase 5), the route
          from encode to rank free of host syncs, the top-10 against the
          numpy oracle fed the card's own query vectors, and the timings
          beside the hashing encoder's;
      (e) an index of ``n_docs`` synthetic docs embedded by the encoder on
          the card (512-token windows, step 450), served and checked the
          same way.
    Returns the launch counts of the (d) batches."""
    enc_cfg = enc_cfg or EncoderConfig()
    rng = np.random.default_rng(seed)
    t0 = time.time()
    tree = init_reference_params(
        enc_cfg, lambda s: rng.standard_normal(s, dtype=np.float32))
    t_draw = time.time() - t0
    t0 = time.time()
    enc = TorchEncoder(enc_cfg, params=tree)
    torch.cuda.synchronize()
    resident = sum(p.numel() * p.element_size()
                   for p in enc.model.parameters())
    log(f"encoder: {enc_cfg}; weights drawn in {t_draw:.1f} s, on "
        f"{enc.device} in {time.time() - t0:.1f} s: {resident / 1e6:.1f} MB "
        f"resident (bf16 weights and table, f32 LayerNorms), params_digest "
        f"{enc.params_digest()}")

    # (b) the card against the port on the CPU (atol 5e-3, cosine 0.9999)
    cpu = TorchEncoder(enc_cfg, params=tree, device="cpu")
    del tree
    long_text = " ".join(rng.choice(words, 600))
    errs = {}
    for B, L in ((1, 16), (16, 16), (64, 16), (1, 512)):
        texts = ([long_text] if L == 512 else
                 query_strings(rng, dfs, words, B))
        check(enc.bucket_len([enc.tokenizer.encode(t) for t in texts]) == L,
              f"encoder texts for L={L}: bucket is not {L}")
        got = enc.encode_batch_device(texts)
        check(got.device.type == enc.device.type and got.shape == (B, enc.dim),
              f"encoder B={B} L={L}: {got.device} {tuple(got.shape)}")
        got = got.cpu().numpy()
        want = cpu.encode_batch(texts)
        e = float(np.abs(got - want).max())
        cos = float((got * want).sum(1).min())
        check(np.isfinite(got).all() and e <= ENC_ATOL and cos >= ENC_COS,
              f"encoder B={B} L={L}: card vs cpu max |d| {e}, min cos {cos}")
        errs[f"B={B} L={L}"] = {"max_abs_err": e, "min_cos": cos}
    log(f"  card vs the port on the cpu, unit embeddings: {json.dumps(errs)}")
    del cpu

    # (c) device time of one forward beside its bound; host enqueue.  A
    # forward is ~900 device operations, near the ~1,000 launches the
    # queue holds, so ``device_ms`` cannot queue one behind a sleep: the
    # device time is the busy time of one traced forward (the union of its
    # device intervals), beside the event-timed wall time of one forward.
    times = {}
    for B, L in ((1, 16), (16, 16), (64, 16), (1, 512), (64, 512)):
        ids = torch.randint(4, enc_cfg.vocab_size, (B, L), device=enc.device,
                            dtype=torch.int32)
        mask = torch.ones_like(ids)

        def fwd():
            with torch.no_grad():
                return enc.model(ids, mask)

        wall = cuda_ms(fwd, 3, 2)
        prof = profile_call(fwd)
        b_ms, b_by, att = encoder_bound(enc_cfg, B, L)
        times[f"B={B} L={L}"] = dict(
            device_busy_ms=None if prof is None else prof["device_busy_ms"],
            device_events=None if prof is None else prof["device_events"],
            wall_ms=wall, bound_ms=b_ms, bound_by=b_by,
            attention_f32_ms=att / F32_OPS * 1e3,
            top_device_ms=None if prof is None else prof["top_device_ms"])
    for B in (1, 64):
        texts = query_strings(rng, dfs, words, B)
        enc.encode_batch_device(texts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode_batch_device(texts)
        times[f"B={B} L=16"]["enqueue_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    log(f"  encoder forward on {name} ({smi}): device busy ms of one traced "
        f"forward and its device operations, event-timed wall ms, the bound "
        f"(bf16 peak; the attention products' time at the f32 peak, which "
        f"the port's f32 products run at, apart), host enqueue ms of one "
        f"encode_batch_device: {json.dumps(times)}")

    # (d) search_batch with the encoder on the 100k index
    t0 = time.time()
    eng = SearchEngine(art, enc, cfg)
    log(f"  encoder engine on the 100k index: built in {time.time() - t0:.1f} s")
    want_bm25 = {"B=1": "bm25_slots", "B=16": "bm25_slots_udedup_sublane",
                 "B=64": "bm25_slots_udedup_i8"}
    results, launches = drive(eng, slot_batches, want_bm25, "encoder")
    for key, qs in slot_batches.items():
        tids, qtf, processed = eng.prepare_queries(qs)
        qv = check_sync_free(lambda: eng.encode_queries(processed),
                             f"encode_queries {key}")
        check(isinstance(qv, torch.Tensor) and qv.device == eng.device,
              f"encode_queries {key}: not a tensor on the card")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng._device_rank(tids, qtf, qv)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        n_sync = sum("synchroniz" in str(w.message) for w in caught)
        log(f"  _device_rank {key} after the encode: {n_sync} host syncs "
            "(sync debug mode 'warn')")
        qn = qv.cpu().numpy()
        same_as_oracle(art, None, cfg, results[key], qs[:3], f"encoder {key}",
                       qvecs=qn)
    log("  encoder path == numpy oracle (fed the card's query vectors) on 3 "
        "queries of each batch")
    time_path(eng, slot_batches, "encoder", name, smi)
    log("  (the slot path's lines above are the same batches with the "
        "hashing encoder)")
    del eng

    # (e) an index embedded by the encoder on the card
    p = dfs[1:] / dfs[1:].sum()  # df-weighted draws of terms 1..
    lens = rng.integers(200, 700, n_docs)
    ids = 1 + rng.choice(len(p), int(lens.sum()), p=p)
    docs = [Document(i, f"https://www.s{i % 97}.de/p{i}", f"t{i}",
                     " ".join(words[j] for j in part))
            for i, part in enumerate(np.split(ids, np.cumsum(lens)[:-1]))]
    spent = [0.0, 0]
    encode = enc.encode_batch

    def timed(texts):  # IndexBuilder's calls into the encoder, timed
        t = time.perf_counter()
        out = encode(texts)
        spent[0] += time.perf_counter() - t
        spent[1] += len(texts)
        return out

    enc.encode_batch = timed
    t0 = time.time()
    try:
        small = IndexBuilder(enc, cfg).build(docs)
    finally:
        del enc.encode_batch
    build_s = time.time() - t0
    check(small.n_chunks == spent[1] and np.isfinite(small.chunk_emb).all(),
          f"encoder index: {small.n_chunks} chunks, {spent[1]} encoded")
    log(f"  encoder index on {name} ({smi}): {n_docs} docs, {small.n_chunks} "
        f"windows of <= {cfg.window_size} tokens, built in {build_s:.2f} s "
        f"({small.n_chunks / build_s:.1f} chunks/s); the encoder's share "
        f"{spent[0]:.2f} s ({spent[1] / spent[0]:.1f} chunks/s)")
    eng_small = SearchEngine(small, enc, cfg)
    df_of = dict(zip(words, dfs))  # the 3 rarest words of 16 of the docs
    qs = [" ".join(sorted(set(docs[i].text.split()), key=df_of.get)[:3])
          for i in rng.choice(n_docs, 16, replace=False)]
    res = eng_small.search_batch(qs, top_k=10)
    check(all(len(r) > 0 for r in res), "encoder index: an empty result")
    _, _, processed = eng_small.prepare_queries(qs)
    qn = eng_small.encode_queries(processed).cpu().numpy()
    same_as_oracle(small, None, cfg, res, qs[:4], "encoder index", qvecs=qn)
    log("  encoder index: 16 queries served, 4 == numpy oracle")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products reduce in f32, as the reference's do: with this on,
    # cuBLAS may round partial sums of a bf16 product (split-K) to bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    art, words, dfs = make_artifacts(args.seed)  # the 100k bench corpus
    log(f"index: {art.n_docs} docs, {art.n_chunks} chunks, "
        f"{art.post_docs.size} postings, made in {time.time() - t0:.1f} s")
    cfg = Config()  # the default: slots layout, U-dedup, exact top-k
    cfg_b = cfg.replace(bm25_layout="blocked")
    enc = HashingEncoder(dim=cfg.embedding_dim)
    t0 = time.time()
    eng = SearchEngine(art, enc, cfg)
    torch.cuda.synchronize()
    d = eng.didx
    log(f"  slot engine on {eng.device}: built in {time.time() - t0:.1f} s; "
        f"{len(d.slot_terms)} stride classes, {len(d.buckets)} buckets, "
        f"{d.slot_stream.terms.numel() * 8 / 1e6:.1f} MB slot postings, "
        f"{sum(e.numel() * 2 for e in d.bucket_emb) / 1e6:.1f} MB bf16 bank, "
        f"{d.resident_bytes() / 1e6:.1f} MB resident")
    t0 = time.time()
    eng_b = SearchEngine(art, enc, cfg_b)
    torch.cuda.synchronize()
    blk = eng_b.didx.blocked
    n_real = int(blk.doc_off[:, -1].sum().item())
    log(f"  blocked engine: built in {time.time() - t0:.1f} s; {blk.n_blocks} "
        f"rows of {blk.p_blk} slots ({n_real} real, "
        f"{1 - n_real / blk.terms.numel():.3f} pads), "
        f"{(blk.terms.numel() * 8 + blk.doc_off.numel() * 4) / 1e6:.1f} MB "
        f"blocked postings (8 B a slot and the doc offsets), "
        f"{eng_b.didx.resident_bytes() / 1e6:.1f} MB resident")

    log("kernels vs plain versions:")
    rows = check_kernels(eng, dfs, rng)
    rows.update(check_blocked_kernels(eng_b, eng, dfs, rng))

    # --- phase 5: each path through the user's entry point -----------------
    slot_batches = {
        "B=1": query_strings(rng, dfs, words, 1),
        "B=16": query_strings(rng, dfs, words, 16),
        "B=64": query_strings(rng, dfs, words, 64, min_distinct=128),
    }
    blocked_batches = {
        "B=1": slot_batches["B=1"],
        "B=64 shared": shared_batch(rng, dfs, words),
        "B=64 wide": slot_batches["B=64"],
    }
    tids, _, _ = eng_b.prepare_queries(blocked_batches["B=64 shared"])
    u_pad = u_pad_for(int(np.unique(tids[tids >= 0]).size))
    check(blocked_udedup_gate(u_pad, *tids.shape),
          f"shared batch: U={u_pad}, T={tids.shape[1]} misses the U-dedup gate")
    paths = {
        "slots": (eng, slot_batches, {
            "B=1": "bm25_slots", "B=16": "bm25_slots_udedup_sublane",
            "B=64": "bm25_slots_udedup_i8"}),
        "blocked": (eng_b, blocked_batches, {
            "B=1": "bm25_blocked", "B=64 shared": "bm25_blocked_udedup",
            "B=64 wide": "bm25_blocked"}),
    }
    results, launches = {}, {}
    for label, (e, batches, want_bm25) in paths.items():
        results[label], launches[label] = drive(e, batches, want_bm25, label)
    # this slice's paths: the legacy-default ops call and the A/B bench
    launches["legacy default"] = legacy_default(eng, rng, dfs, words, cfg,
                                                enc, art)
    launches["bench"] = bench_phase(eng, dfs)

    t0 = time.time()
    cpu = SearchEngine(art, enc, cfg, bank_dtype=torch.bfloat16, device="cpu")
    for key in ("B=1", "B=16"):
        want = cpu.search_batch(slot_batches[key], top_k=10)
        for i, (g, w) in enumerate(zip(results["slots"][key], want)):
            same_top(g, w, f"card vs cpu {key} q{i}")
    log(f"  slot path on the card == cpu engine on the B=1 and B=16 batches "
        f"({time.time() - t0:.1f} s)")
    same_as_oracle(art, enc, cfg, results["slots"]["B=16"],
                   slot_batches["B=16"][:3], "slot path")
    log("  slot path == numpy oracle on 3 queries")
    same_batch = {"B=1": "B=1", "B=64 wide": "B=64"}  # keys of slot_batches
    for key, qs in blocked_batches.items():
        want = (results["slots"][same_batch[key]] if key in same_batch
                else eng.search_batch(qs, top_k=10))
        for i, (g, w) in enumerate(zip(results["blocked"][key], want)):
            same_top(g, w, f"blocked vs slots {key} q{i}")
    log("  blocked path == slot path on the card, top-10 of every batch")
    same_as_oracle(art, enc, cfg_b, results["blocked"]["B=64 shared"],
                   blocked_batches["B=64 shared"][:3], "blocked path")
    log("  blocked path == numpy oracle on 3 queries")
    del cpu

    for label, (e, batches, _) in paths.items():
        time_path(e, batches, label, name, smi)

    # --- the bi-encoder's path ----------------------------------------------
    launches["encoder"] = encoder_phase(args.seed, art, words, dfs, cfg,
                                        slot_batches, name, smi)

    # --- phase 6: small phases ----------------------------------------------
    check_empty_index(cfg, enc)
    check_wide_batches(args.seed, eng.device)
    eng_ax = SearchEngine(art, enc, cfg.replace(approx_candidates=True))
    check(eng_ax._approx, "approx_candidates=True did not resolve to True")
    for key in ("B=16", "B=64"):
        for a, b in zip(eng_ax.rank_batch(slot_batches[key]),
                        eng.rank_batch(slot_batches[key])):
            check(np.array_equal(a, b), f"approx_candidates=True {key}")
    log("approx_candidates=True: rank_batch equal to the exact engine at "
        "B=16 and B=64")
    del eng_ax

    out = []
    for k in cuda_lib.KERNELS:
        r = rows[k.name]
        per_batch = {f"{label} {key}": launches[label][key][k.name]
                     for label in launches for key in launches[label]}
        check(sum(per_batch.values()) > 0,
              f"{k.name}: launched no time on the main paths")
        out.append({
            "name": k.name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": sum(per_batch.values()),
            "launches_per_batch": per_batch,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            **{key: r[key] for key in ("bound_old_ms",
                                       "tpu_formulation_bound_ms", "by_batch")
               if key in r},
        })
    log(f"total {time.time() - t_start:.1f} s")
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
