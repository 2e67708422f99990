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
  5c. stage 3 and the search assistant at full width (weights drawn from
     --seed; the configurations of runs/cross-encoder-real and
     runs/summarizer-real written out, no checkpoint read): rescore on the
     card against the port on the CPU; search_batch with cross_encoder=
     on the 100k index at B = 1, 16, 64 (launches checked as in 5, the
     docs, windows and original_similarity of stage 2 kept, scores and
     order against a CPU rescore), p50, forwards a batch and traces; the
     decoder's greedy decode on the card against the CPU's by teacher
     forcing, free of host syncs, with ms a summary; and
     GenerativeSummarizer.generate_summary over a stage-3 result;
  5d. the serving surface on the slot engine: the C++ data plane
     (serve_fastpath, pipeline 2) on 16 single queries against
     search_batch_indices and search_batch, then 4,000 requests over 64
     connections from a separate process (launches against its device
     batches, q/s and p50/p95/p99); the asyncio control plane
     (SearchService) on 16 sequential /api/search (the data plane's
     docs), 64 clients x 8 requests (coalescing > 1), /api/health,
     /api/stats, /api/rerank, /api/batch_search and /api/profile (a
     trace holding CUDA kernel events); bank_dtype="int8" at B = 1, 16,
     64 (kernel 4 never launched, top-10 near the bf16 engine's and equal
     to the CPU port's int8 engine); and the serving CLI booted as a
     subprocess on a saved 10,000-doc cut with --int8-bank and
     --fastpath-port (both planes the same docs, exit 0 or -15 on
     SIGTERM); both loads go through ``eval.load_test`` (its
     ``data_plane_load`` and ``http_load``, each in a separate process);
  5e. the offline path at full width (12 layers, 768 wide; warm-started
     from runs/encoder-real where it is present, else from --seed):
     stage A InfoNCE at B = 256, L = 128, hard negatives mined with the
     trained tower, stage B InfoNCE with them at B = 160, cosine steps
     (warm step ms, tokens/s, bound, device busy and idle share, peak
     memory); one step at B = 8, L = 32 on the card against the CPU port
     (from the trained tree, the loss and every gradient leaf in f32 and
     the loss in bf16; from a tree drawn from --seed, the loss and every
     gradient leaf in bf16); save_encoder in f16
     and two reloads; BuildPipeline over 2,000 docs in shards of 512, a
     deleted shard resumed, and the index CLI as a subprocess over a
     CrawlStore (the same artifacts); search_batch on the built index at
     B = 1, 16, 64 (launches as in 5, the numpy oracle); the
     cross-encoder trainer and its save, save_decoder, and the training
     CLI at its defaults but for 512 synthetic pairs (depth cut from its
     default 2,048, ~30 s saved) as a subprocess; outputs under
     build/offline_smoke/;
  5f. the sharded backend on the 100k index: ``SearchEngine.sharded`` over
     eight shards on the card (``Mesh([cuda:0] * 8, ("shard",))``) at B =
     1, 16, 64 (each shard launches the batch's BM25 kernel once and kernel
     4 once a bucket; top-10, ``bm25_search`` and ``dense_search`` against
     the one-card engine; p50 of both in turns, one trace each, the
     collectives a call); a (dp 2, shard 4) mesh; the int8 bank; the scatter
     stage 1 (``use_pallas=False``) one-card and sharded at B = 16, its
     keyed BM25 against kernel 1; ``ShardedQueryEncoder`` at full width
     against one encode; two processes of the multihost CLI, four shards
     each on the card over gloo, flat and hierarchical, against the
     one-card ranking of the demo corpus; the serving CLI with
     ``--sharded`` on phase 5d's cut; with several cards, the shards over
     distinct cards;
  5g. the last modules: (a) the dp x tp training step at runs/encoder-
     real's configuration (12L/768d; warm-started from it where present,
     else from --seed) on ``Mesh([cuda:0] * 4).reshape(2, 2), ("dp",
     "tp"))``: one f32 step at B = 8, L = 32 against the one-card trainer
     (loss to 1e-5, every gradient leaf and every updated leaf to 1e-4 of
     its largest magnitude), stage A's shapes (InfoNCE, B = 256, L = 128)
     timed beside one card (step ms, tokens/s, device operations, busy and
     idle share, peak memory), ``train_cli --dp 2 --tp 2`` refused with
     fewer than four cards, and with four or more cards the mesh over
     distinct cards too; (b) ``entry()``'s flagship forward at (8, 512) on
     the card against the CPU port (5e-3), ``dryrun_multichip(8)`` on the
     card; (c) ``dedup_query_terms_device`` on phase 3's B = 16 and 64
     batches: equal to the host dedup bit for bit, free of host syncs,
     kernels 2 / 3 fed from it equal to the host route bit for bit, a
     budget below the distinct count dropping ids as on the CPU; (d) the
     load test's CLI (``eval.load_test --native engine``) as a subprocess;
     (e) the real-text pass: 2,000 pages of the installed packages'
     docstrings (``tools/make_real_corpus.build_site``) on 8 loopback
     hosts served by ``http.server``, crawled by the port's crawler
     (asyncio transport, stdlib parser; no /private page stored),
     ``merge_crawls``, ``BuildPipeline`` with the bi-encoder on the card,
     ``search_batch`` at B = 1 / 16 / 64 (launches as in 5, top-10
     against the numpy oracle), ``POST /api/batch_search_file``, and
     recall@10 / NDCG@10 against the oracle printed; outputs under
     build/real_smoke/;
  6. small phases: an empty index (served by the blocked kernel, every
     entry point returns []); U = 1152 distinct terms and T = 80 term
     slots on every BM25 kernel (kernels 1-3 and 5-8) against its plain
     version, and the device dedup of that batch feeding kernels 2 and 3
     (as in 5g (c));
     approx_candidates=True equal to the exact engine;
  7. a {"kernels": [...]} JSON line (time, bound, plain time, error per kernel),
     the nvidia-smi line, and the final {"ok": true, ...} line.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import copy
import dataclasses
import http.client
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

from modern_search_engines_project_tpu_torch import bench_kernels
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.crawler import (
    AsyncioTransport,
    Crawler,
    CrawlStore,
    Fetcher,
)
from modern_search_engines_project_tpu_torch.crawler.preprocess import merge_crawls
from modern_search_engines_project_tpu_torch.entry import dryrun_multichip, entry
from modern_search_engines_project_tpu_torch.eval import load_test
from modern_search_engines_project_tpu_torch.index import (
    BuildPipeline,
    Document,
    IndexBuilder,
    load_artifacts,
    save_artifacts,
)
from modern_search_engines_project_tpu_torch.kernel_times import device_ms
from modern_search_engines_project_tpu_torch.models import (
    CrossEncoderReranker,
    DecoderConfig,
    EncoderConfig,
    GreedyGenerator,
    HashingEncoder,
    TorchEncoder,
    TrainConfig,
    Trainer,
    WordVocab,
    cross_encoder_params_to_reference,
    init_cross_encoder_params,
    init_decoder_params,
    init_reference_params,
    load_decoder,
    load_encoder,
    mine_hn_triples,
    params_to_reference,
    read_checkpoint,
    save_decoder,
    save_encoder,
    train_cross_encoder,
)
from modern_search_engines_project_tpu_torch.models.decoder import build_decoder
from modern_search_engines_project_tpu_torch.parallel.sharding import Mesh
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
    bm25_score_slots_udedup,
    dedup_query_terms,
    dedup_query_terms_device,
    slots_keyed,
    slots_plain,
    slots_udedup_keyed,
    slots_udedup_plain,
    u_pad_for,
    udedup_plan,
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
    resolve_device,
)
from modern_search_engines_project_tpu_torch.retrieval.engine import SearchEngine
from modern_search_engines_project_tpu_torch.retrieval.numpy_ref import (
    hybrid_search_numpy,
    preprocess_query,
)
from modern_search_engines_project_tpu_torch.serving import (
    GenerativeSummarizer,
    SearchService,
)
from modern_search_engines_project_tpu_torch.serving.fastpath import (
    attach_stub,
    build_fragments,
    make_server,
    serve_fastpath,
)
from modern_search_engines_project_tpu_torch.serving.http import ServerThread
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
# Stage 3 and the assistant, card against the port on the CPU (same bf16
# arithmetic, other reduction orders, 4 layers): cross-encoder sigmoid
# scores to 5e-3 (the port against the reference on the CPU: 2.5e-4 on
# the trained checkpoint); decoder logits to 2^-5 of their scale (the
# port against the reference: 2^-6 at full width).
CE_ATOL = 5e-3
DEC_RTOL = 2.0 ** -5
# The committed checkpoints' configurations, written out: this script
# reads no checkpoint, so it runs where runs/ is absent.  They equal
# runs/cross-encoder-real/config.json and
# runs/summarizer-real/config.json (tests/test_torch_cross_encoder.py
# holds them to it).
CE_CFG = EncoderConfig(vocab_size=50257, dim=384, n_layers=4, n_heads=6,
                       mlp_ratio=4, max_len=192, dtype="bfloat16",
                       rope_base=10000.0)
DEC_CFG = DecoderConfig(vocab_size=32000, dim=256, n_layers=4, n_heads=4,
                        mlp_ratio=4, max_len=192, dtype="bfloat16",
                        rope_base=10000.0)


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


class SpmmYardstick:
    """The BM25 rows' library call, a yardstick timed here and used nowhere
    in the port: one ``torch.sparse.mm`` (cuSPARSE SpMM) of the [docs, V]
    CSR impact matrix (from the index's ``indptr``, ``post_docs`` and
    ``post_impact``) by the dense [V, B] query-weight matrix, which gives
    every doc's BM25 score (without the kernels' keys)."""

    def __init__(self, art, dev):
        V, D = art.n_terms, art.n_docs
        term = np.repeat(np.arange(V, dtype=np.int64), np.diff(art.indptr))
        docs = np.asarray(art.post_docs, np.int64)
        order = np.lexsort((term, docs))  # doc-major, terms ascending
        crow = np.zeros(D + 1, np.int64)
        np.cumsum(np.bincount(docs, minlength=D), out=crow[1:])
        with warnings.catch_warnings():  # "beta state", invariant checks
            warnings.simplefilter("ignore")
            self.csr = torch.sparse_csr_tensor(
                torch.as_tensor(crow), torch.as_tensor(term[order]),
                torch.as_tensor(np.asarray(art.post_impact)[order]),
                size=(D, V), dtype=torch.float32, device=dev)
        self.V, self.dev = V, dev

    def ms(self, ids, w):
        """Device ms of the product for queries given as term ids [B, T]
        with weights [B, T] (pads -1), or distinct ids [U] with weights
        [2B, U] (the U-dedup form; rows B..2B are presence)."""
        ids = torch.as_tensor(ids, device=self.dev).long()
        w = torch.as_tensor(w, device=self.dev)
        if ids.dim() == 1:  # U-dedup: w[:B] weights, w[B:] presence
            B = w.shape[0] // 2
            ids, w = ids[None, :].expand(B, -1), w[:B]
        B = ids.shape[0]
        W = torch.zeros(self.V, B, device=self.dev)
        ok = ids >= 0
        cols = torch.arange(B, device=self.dev)[:, None].expand_as(ids)
        W.index_put_((ids[ok], cols[ok]), w[ok].float(), accumulate=True)
        try:
            return device_ms(lambda: torch.sparse.mm(self.csr, W), 20)
        except RuntimeError:  # the call waited on the host: time it so
            log("  torch.sparse.mm synchronised with the host; its time "
                "includes the host's enqueue")
            return cuda_ms(lambda: torch.sparse.mm(self.csr, W), 20)


def check_kernels(eng, dfs, rng):
    """Phase 4: each kernel against its plain version on the same tensors;
    the BM25 rows also beside their library call (``SpmmYardstick``)."""
    d = eng.didx
    dev = eng.device
    spmm = SpmmYardstick(eng.art, dev)
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
        lms = spmm.ms(tids, qtf)
        matched = matched_postings(t)
        nb = table_bytes + matched * 4 + tids.nbytes + qtf.nbytes
        nb += got.numel() * 4
        b_ms, b_by = bound(nb, n_real * B * (8 + 2), F32_OPS)
        log(f"  bm25_slots B={B} T=8: err {e:.2e} kernel {ms:.4f} ms "
            f"plain {pms:.4f} ms library (torch.sparse.mm) {lms:.4f} ms "
            f"bound {b_ms:.4f} ms ({b_by}; {matched} of "
            f"{n_real} postings matched)")
        if B == 1:  # the engine's plain-kernel branch serves B < 8
            k1 = dict(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                      library_ms=lms)
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
            lms = spmm.ms(uids, w)
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
                f"{ms:.4f} ms plain {pms:.4f} ms library (torch.sparse.mm) "
                f"{lms:.4f} ms bound {b_ms:.4f} ms ({b_by}; "
                f"{matched} of {n_real} postings matched){log_ops}")
            if by_df:
                by_batch[f"B={B} U={u.numel()}"] = dict(
                    ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lms, **extra)
            if B == main_b and by_df:
                main = dict(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lms, **extra)
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
    spmm = SpmmYardstick(eng_b.art, dev)
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
        lms = spmm.ms(tids, qtf)
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
            f"plain {pms:.4f} ms library (torch.sparse.mm) {lms:.4f} ms "
            f"bound {b_ms:.4f} ms ({b_by}); compare-count "
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
                                  bound_by=b_by, bound_old_ms=old_ms,
                                  library_ms=lms)
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
        lms = spmm.ms(uids, w)
        matched = matched_postings(u)
        nb = base_bytes + matched * 4 + uids.nbytes + w.nbytes
        nb += got.numel() * 4
        b_ms, b_by = bound(nb, n_real + matched * 2 * B, F32_OPS)
        log(f"  bm25_blocked_udedup B={B} U={u.numel()}: err {e:.2e} kernel "
            f"{ms:.4f} ms plain {pms:.4f} ms library (torch.sparse.mm) "
            f"{lms:.4f} ms bound {b_ms:.4f} ms ({b_by}; "
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
            ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=lms)
        if pool:  # the engine's kernel-8 branch: B = 64 sharing terms
            main = dict(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lms)
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


def drive(eng, batches, want_bm25, label, top_k=10):
    """Each batch through ``search_batch`` as its own path: every launch
    counter set to 0 just before, read just after; the batch's BM25 kernel
    must have launched once, the stats kernel once per bucket, nothing
    else.  Returns (results, launches) keyed like ``batches``."""
    n_buckets = len(eng.didx.buckets)
    results, launches = {}, {}
    for key, qs in batches.items():
        for k in cuda_lib.KERNELS:
            k.launches = 0
        results[key] = eng.search_batch(qs, top_k=top_k)
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
    return device_dedup_wide(stream, vt, vi, tids, qtf, dev)


def device_dedup_wide(stream, vt, vi, tids, qtf, dev):
    """Phase 5g (c) on the U = 1152 / T = 80 batch: the device dedup equal
    to the host's bit for bit, with no host sync, and kernels 2 and 3 fed
    from it equal to the host route bit for bit.  Returns the launches of
    the device route's kernel calls."""
    uids_h, w_h = dedup_query_terms(tids, qtf)
    t, q = (torch.as_tensor(x, device=dev) for x in (tids, qtf))
    uids_d, w_d = check_sync_free(
        lambda: dedup_query_terms_device(t, q, uids_h.size),
        f"dedup_query_terms_device U={uids_h.size}, T=80")
    check(np.array_equal(uids_d.cpu().numpy(), uids_h)
          and np.array_equal(w_d.cpu().numpy(), w_h),
          "device dedup U=1152: differs from the host's")
    u_h, w_ht = (torch.as_tensor(x, device=dev) for x in (uids_h, w_h))
    launches = {}
    for v in ("sublane", "i8"):
        want = slots_udedup_keyed(stream, vt, vi, u_h, w_ht, v)
        reset_launches()
        got = slots_udedup_keyed(stream, vt, vi, uids_d, w_d, v)
        launches[f"U=1152 {v}"] = read_launches()
        check(torch.equal(got, want),
              f"device dedup U=1152: kernel {v} differs from the host route")
    log(f"  device dedup U={uids_h.size}, T=80: equal to the host's; kernels 2 "
        f"and 3 fed from it == the host route bit for bit")
    return launches


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


def decode_step_bound(cfg):
    """Least time of one greedy step of ``cfg`` (B = 1): the bf16 weights
    and the token table read once (the table serves the L embedding rows
    and the tied head), ids and mask in, one row of bf16 logits out; the
    products' operations for L tokens plus the head's one row, at the bf16
    tensor-core peak."""
    D, Hd, V, L = cfg.dim, cfg.dim * cfg.mlp_ratio, cfg.vocab_size, cfg.max_len
    w = cfg.n_layers * (3 * D * D + D * D + 2 * Hd * D + Hd * D)
    nbytes = w * 2 + V * D * 2 + L * 8 + V * 2
    ops = 2 * w * L + 4 * L * L * D * cfg.n_layers + 2 * V * D
    return bound(nbytes, ops, BF16_OPS)


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


def synthetic_docs(rng, words, dfs, n_docs, first_id=0):
    """``n_docs`` documents of 200-700 df-drawn words of the phase-3
    corpus, ids from ``first_id``."""
    p = dfs[1:] / dfs[1:].sum()  # df-weighted draws of terms 1..
    lens = rng.integers(200, 700, n_docs)
    ids = 1 + rng.choice(len(p), int(lens.sum()), p=p)
    return [Document(first_id + i, f"https://www.s{i % 97}.de/p{i}", f"t{i}",
                     " ".join(words[j] for j in part))
            for i, part in enumerate(np.split(ids, np.cumsum(lens)[:-1]))]


def rare_terms_queries(docs, words, dfs, rng, B, n_terms=3):
    """B queries of the ``n_terms`` rarest words of B distinct docs."""
    df_of = dict(zip(words, dfs))
    return [" ".join(sorted(set(docs[i].text.split()), key=df_of.get)[:n_terms])
            for i in rng.choice(len(docs), B, replace=False)]


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
    docs = synthetic_docs(rng, words, dfs, n_docs)
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
    qs = rare_terms_queries(docs, words, dfs, rng, 16)
    res = eng_small.search_batch(qs, top_k=10)
    check(all(len(r) > 0 for r in res), "encoder index: an empty result")
    _, _, processed = eng_small.prepare_queries(qs)
    qn = eng_small.encode_queries(processed).cpu().numpy()
    same_as_oracle(small, None, cfg, res, qs[:4], "encoder index", qvecs=qn)
    log("  encoder index: 16 queries served, 4 == numpy oracle")
    return launches


class SyntheticWindows:
    """Window texts of the synthetic index, made on demand from the seed
    and the window's index and kept: twelve sentences of twelve df-drawn
    words (the index stores only "window i"; stage 3 and the summarizer
    read real-length text).  Indexing and ``len`` only, as the engine
    reads ``window_texts``."""

    def __init__(self, seed, words, dfs, n):
        self.seed, self.words, self.n = seed, words, n
        self.cdf = np.cumsum(dfs[1:] / dfs[1:].sum())
        self.cache = {}

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        text = self.cache.get(i)
        if text is None:
            r = np.random.default_rng((self.seed, int(i))).random(144)
            ids = 1 + np.minimum(np.searchsorted(self.cdf, r),
                                 len(self.cdf) - 1)
            ws = [self.words[j] for j in ids.tolist()]
            text = " ".join(" ".join(ws[k : k + 12]) + "."
                            for k in range(0, 144, 12))
            self.cache[i] = text
        return text


def n_forwards(results, batch_size):
    """Cross-encoder forwards a batch ran: one per ``batch_size`` rows of
    each query."""
    return sum(-(-len(r) // batch_size) for r in results)


def check_stage3(ce_cpu, q, rows, what):
    """One query's stage-3 rows against the port's CPU rescore of the same
    windows: sigmoid scores to CE_ATOL, and the card's order wherever
    neighbouring CPU scores differ by more than twice that.  Returns the
    max abs error."""
    got = np.array([r.similarity_score for r in rows], np.float32)
    want = ce_cpu.rescore(q, [r.window_text for r in rows])
    err = float(np.abs(got - want).max())
    check(err <= CE_ATOL, f"{what}: card vs cpu rescore max |d| {err}")
    flips = [i for i in range(len(rows) - 1)
             if want[i + 1] - want[i] > 2 * CE_ATOL]
    check(not flips, f"{what}: order against the cpu scores at {flips}")
    return err


def stage3_phase(seed, art, words, dfs, cfg, plain, slot_batches, name, smi):
    """The cross-encoder stage 3 at full width (``CE_CFG``: 4 layers, 384
    wide, 6 heads, 50,257 ids, L = 192) with weights drawn from ``seed``:
      (a) ``rescore`` on the card against the port on the CPU on the 100
          windows of one query's result and on 32 windows that fill L;
      (b) ``search_batch`` with ``cross_encoder=`` on the 100k index at
          B = 1, 16 and 64 (top_k_reranking = 100 rows a query), each
          batch's launches checked as in phase 5; each query's docs,
          windows and ``original_similarity`` equal to ``plain``'s (the
          same index without stage 3); scores in [0, 1], descending, and
          equal to the CPU rescore of the same windows (one query a batch);
      (c) p50 and queries/s, forwards a batch, one torch.profiler trace of
          a B = 1 and a B = 16 batch and one of a 100-window rescore
          (device operations a forward).
    Returns (the launch counts of the (b) batches, one query, its rows)."""
    rng = np.random.default_rng(seed + 3)
    t_phase = t0 = time.time()
    tree = init_cross_encoder_params(
        CE_CFG, lambda s: rng.standard_normal(s, dtype=np.float32))
    ce = CrossEncoderReranker(CE_CFG, params=tree)
    ce_cpu = CrossEncoderReranker(CE_CFG, params=tree, device="cpu")
    del tree
    art3 = dataclasses.replace(
        art, window_texts=SyntheticWindows(seed, words, dfs, art.n_chunks))
    eng = SearchEngine(art3, plain.encoder, cfg, cross_encoder=ce)
    torch.cuda.synchronize()
    log(f"stage 3: {CE_CFG}; weights drawn and engine built in "
        f"{time.time() - t0:.1f} s, batch_size {ce.batch_size}")

    want_bm25 = {"B=1": "bm25_slots", "B=16": "bm25_slots_udedup_sublane",
                 "B=64": "bm25_slots_udedup_i8"}
    results, launches = drive(eng, slot_batches, want_bm25, "stage 3",
                              top_k=None)
    errs, fwd = {}, {}
    for key, qs in slot_batches.items():
        base = plain.search_batch(qs)
        fwd[key] = n_forwards(results[key], ce.batch_size)
        for b, (got, want) in enumerate(zip(results[key], base)):
            before = {r.doc_id: r for r in want}
            check(set(before) == {r.doc_id for r in got},
                  f"stage 3 {key} q{b}: another doc set than stage 2")
            for r in got:
                w = before[r.doc_id]
                check(r.window_index == w.window_index and
                      r.original_similarity == w.original_similarity,
                      f"stage 3 {key} q{b}: row of doc {r.doc_id} changed")
                check(0.0 <= r.similarity_score <= 1.0,
                      f"stage 3 {key} q{b}: score {r.similarity_score}")
        errs[key] = check_stage3(ce_cpu, qs[0], results[key][0],
                                 f"stage 3 {key} q0")
    log(f"  stage 3 == stage 2's docs, windows and original_similarity on "
        f"every query; card vs cpu rescore of q0's rows, max abs err: "
        f"{json.dumps(errs)}; forwards a batch: {json.dumps(fwd)}")

    # (a) rescore alone: a stage-2 result's 100 windows, 32 full windows
    q = slot_batches["B=1"][0]
    rows = results["B=1"][0]
    texts = [r.window_text for r in rows]
    long_texts = [" ".join(art3.window_texts[i] for i in range(j, j + 2))
                  for j in range(0, 64, 2)]
    ids, mask = ce._encode_pairs(q, long_texts)
    check(min(sum(m) for m in mask) == CE_CFG.max_len,
          "stage 3: the long windows do not fill L")
    e = {}
    for label, t in (("100 windows of q0 (B=1)", texts),
                     ("32 windows filling L", long_texts)):
        got = ce.rescore(q, t)
        want = ce_cpu.rescore(q, t)
        e[label] = float(np.abs(got - want).max())
        check(e[label] <= CE_ATOL and np.isfinite(got).all(),
              f"stage 3 rescore {label}: card vs cpu max |d| {e[label]}")
    log(f"  rescore on the card vs the port on the cpu, max abs err of the "
        f"sigmoid scores: {json.dumps(e)}")
    del ce_cpu

    # (c) timings
    reps = {"B=1": 10, "B=16": 5, "B=64": 3}
    for key, qs in slot_batches.items():
        eng.times = StageTimes()
        ts = []
        for _ in range(reps[key]):
            t0 = time.perf_counter()
            eng.search_batch(qs)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        p50 = float(np.median(ts))
        host = {k: v["mean_ms"] for k, v in eng.times.report().items()}
        log(f"  stage 3 search_batch {key}: p50 {p50 * 1e3:.3f} ms over "
            f"{reps[key]} calls, {len(qs) / p50:.2f} queries/s on {name} "
            f"({smi}), {fwd[key]} cross-encoder forwards; host stage means "
            f"(ms, format_diversify holds stage 3): {host}")
        if key == "B=64":
            continue
        prof = profile_call(lambda: eng.search_batch(qs))
        if prof is None:
            log(f"    torch.profiler, stage 3 {key}: no device events in "
                "the trace, device time not measured")
        else:
            prof["idle_share_of_p50"] = 1.0 - prof["device_busy_ms"] / (
                p50 * 1e3)
            log(f"    torch.profiler, one stage 3 search_batch {key}: "
                f"{json.dumps(prof)}")
    prof = profile_call(lambda: ce.rescore(q, texts))
    n_f = -(-len(texts) // ce.batch_size)
    b_ms, b_by, _ = encoder_bound(CE_CFG, ce.batch_size, CE_CFG.max_len)
    if prof is None:
        log("    torch.profiler, rescore: no device events, not measured")
    else:
        log(f"    torch.profiler, one rescore of {len(texts)} windows "
            f"({n_f} forwards of {ce.batch_size} x {CE_CFG.max_len}): "
            f"{prof['device_events'] / n_f:.1f} device operations and "
            f"{prof['device_busy_ms'] / n_f:.4f} device busy ms a forward "
            f"(bound of a full forward {b_ms:.4f} ms, {b_by}); "
            f"{json.dumps(prof)}")
    log(f"  stage 3 phase: {time.time() - t_phase:.1f} s")
    return launches, q, rows


def teacher_forced(model, prompt, toks):
    """Logits [n, V] f32 at the positions that emitted ``toks``, a decode
    of ``prompt`` that stayed inside the model's length, from one forward
    over the prompt and the decode."""
    L = model.cfg.max_len
    seq = list(prompt) + list(toks)
    check(len(seq) <= L, f"teacher forcing: {len(seq)} tokens > {L}")
    x = np.zeros((3, 1, L), np.int32)
    x[0, 0, : len(seq)] = seq
    x[1, 0, : len(seq)] = 1
    x[2, 0, : len(toks)] = np.arange(len(prompt) - 1, len(seq) - 1)
    dev = model.tok.device
    t = torch.from_numpy(x).to(dev)
    with torch.no_grad():
        out = model(t[0], t[1], t[2, :, : len(toks)])
    return out[0].float().cpu().numpy()


def decoder_phase(seed, words, query, windows, name, smi):
    """The summary decoder at full width (``DEC_CFG``: 4 layers, 256 wide,
    32,000 ids, L = 192) with weights drawn from ``seed`` and a
    ``WordVocab`` of the synthetic corpus's words, prompted as
    ``GenerativeSummarizer`` prompts it with ``windows`` (the top-10
    windows of a stage-3 result):
      (a) the port's greedy decode on the CPU (48 steps), then its tokens
          teacher-forced through the card's model and the CPU's: logits at
          every generated position within DEC_RTOL of their scale;
      (b) the card's greedy decode equal to the CPU's up to the first step
          whose CPU top-2 margin is under twice that tolerance, with no
          host sync inside ``generate_device``;
      (c) ms a summary (p50 of 5), device busy, operations a step;
      (d) ``GenerativeSummarizer.generate_summary`` over ``windows``: a
          non-empty string, from the decode or the extractive fallback."""
    rng = np.random.default_rng(seed + 4)
    t_phase = t0 = time.time()
    tree = init_decoder_params(
        DEC_CFG, lambda s: rng.standard_normal(s, dtype=np.float32))
    model = build_decoder(DEC_CFG, tree, resolve_device())
    cpu_model = build_decoder(DEC_CFG, tree, torch.device("cpu"))
    del tree
    vocab = WordVocab.build([" ".join(words)], max_words=DEC_CFG.vocab_size)
    summ = GenerativeSummarizer(model, vocab)
    gen, gen_cpu = summ.gen, GreedyGenerator(cpu_model, device="cpu")
    cut = [w[:4000] for w in windows[:10] if w]
    prompt = summ.prompt_ids(query, cut)
    n_new = summ.max_new
    log(f"decoder: {DEC_CFG}; vocab {len(vocab)} words; weights drawn, on "
        f"{gen.device} and the cpu in {time.time() - t0:.1f} s; prompt of "
        f"{len(prompt)} tokens, {n_new} new")

    t0 = time.time()
    cpu_toks = gen_cpu.generate([prompt], n_new)[0]
    t_cpu = time.time() - t0
    want = teacher_forced(cpu_model, prompt, cpu_toks)
    got = teacher_forced(model, prompt, cpu_toks)
    tol = DEC_RTOL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    check(np.isfinite(got).all() and err <= tol,
          f"decoder teacher-forced logits: card vs cpu max |d| {err} > {tol}")
    top2 = np.sort(want, axis=-1)[:, -2:]
    near = np.nonzero(top2[:, 1] - top2[:, 0] < 2 * tol)[0]
    first = int(near[0]) if near.size else n_new
    card = check_sync_free(lambda: gen.generate_device([prompt], n_new),
                           "generate_device")
    card = card.cpu().numpy()[0]
    check(card.shape == cpu_toks.shape and
          np.array_equal(card[:first], cpu_toks[:first]),
          f"decoder: card tokens {card[:first]} vs cpu {cpu_toks[:first]} "
          f"before the first near-tie (step {first})")
    same = int(np.argmin(card == cpu_toks)) if (card != cpu_toks).any() \
        else n_new
    log(f"  teacher-forced logits, card vs cpu: max |d| {err:.6f} (tol "
        f"{tol:.6f} = 2^-5 of scale {tol / DEC_RTOL:.4f}); first near-tie "
        f"(cpu top-2 margin < 2 tol) at step {first} of {n_new}; card and "
        f"cpu tokens equal for the first {same} steps; cpu decode "
        f"{t_cpu:.2f} s")

    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        gen.generate([prompt], n_new)
        ts.append(time.perf_counter() - t0)
    p50 = float(np.median(ts))
    prof = profile_call(lambda: gen.generate([prompt], n_new))
    b_ms, b_by = decode_step_bound(DEC_CFG)
    log(f"  bound of one decode step: {b_ms:.5f} ms ({b_by})")
    if prof is None:
        log(f"  decode on {name} ({smi}): p50 {p50 * 1e3:.3f} ms a summary "
            f"({n_new} steps); no device events, device time not measured")
    else:
        log(f"  decode on {name} ({smi}): p50 {p50 * 1e3:.3f} ms a summary "
            f"({n_new} steps, {p50 * 1e3 / n_new:.3f} ms a step); "
            f"{prof['device_events'] / n_new:.1f} device operations and "
            f"{prof['device_busy_ms'] / n_new:.4f} device busy ms a step; "
            f"idle share of p50 {1 - prof['device_busy_ms'] / (p50 * 1e3):.4f}"
            f"; {json.dumps(prof)}")

    decoded = vocab.decode(card).strip()
    t0 = time.perf_counter()
    text = summ.generate_summary(query, windows)
    t_sum = time.perf_counter() - t0
    check(isinstance(text, str) and text, "generate_summary: empty")
    log(f"  assistant: generate_summary over the top-10 windows of a stage-3 "
        f"result in {t_sum * 1e3:.1f} ms, {len(text)} chars from the "
        f"{'decode' if text == decoded else 'extractive fallback'}: "
        f"{text[:120]!r}")
    log(f"  decoder and assistant phase: {time.time() - t_phase:.1f} s")


ROOT = os.path.dirname(os.path.abspath(__file__))
# The CLI's saved index: the first 10,000 docs of the 100k corpus (the save,
# the subprocess's load and its warmup stay within seconds).
SERVE_CUT_DOCS = 10_000
Row = collections.namedtuple("Row", "doc_id similarity_score window_index")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def http_json(port, method, path, payload=None, timeout=300):
    """(status, parsed body) of one request to 127.0.0.1:port."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request(method, path,
                  None if payload is None else json.dumps(payload),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


def data_plane_load(port, bodies):
    """The data plane's load (``eval.load_test.data_plane_load``, a separate
    process): 64 connections, 4,000 requests rotating over ``bodies``."""
    return load_test.in_subprocess("data_plane_load", port=port,
                                   bodies=bodies, n_conns=64,
                                   total_requests=4000, timeout_s=600)


def same_docs(got, want, what, rtol=1e-5):
    """Two /api/search document lists: the same doc ids in order, scores
    to ``rtol`` (the data plane prints 6 significant digits)."""
    check([d["doc_id"] for d in got] == [d["doc_id"] for d in want],
          f"{what}: docs {[d['doc_id'] for d in got]} vs "
          f"{[d['doc_id'] for d in want]}")
    for a, b in zip(got, want):
        check(abs(a["score"] - b["score"]) <= rtol * max(1.0, abs(b["score"])),
              f"{what}: score {a['score']} vs {b['score']}")


def cut_artifacts(art, n_docs, windows):
    """The first ``n_docs`` docs of ``art`` with their postings (impacts
    as they are; df and idf recounted), chunks and window texts (a list)."""
    V = art.n_terms
    keep = np.asarray(art.post_docs) < n_docs
    term = np.repeat(np.arange(V), np.diff(art.indptr))
    df = np.bincount(term[keep], minlength=V).astype(np.int32)
    indptr = np.zeros(V + 1, np.int32)
    np.cumsum(df, out=indptr[1:])
    n_ch = int(art.doc_chunk_start[n_docs - 1] + art.doc_n_chunks[n_docs - 1])
    doc_len = np.asarray(art.doc_len[:n_docs])
    return dataclasses.replace(
        art, indptr=indptr, post_docs=art.post_docs[keep],
        post_impact=art.post_impact[keep],
        idf=np.log((n_docs - df + 0.5) / (df + 0.5)).astype(np.float32),
        df=df, doc_len=doc_len, avgdl=float(doc_len.mean()),
        chunk_emb=art.chunk_emb[:n_ch], chunk_doc=art.chunk_doc[:n_ch],
        doc_chunk_start=art.doc_chunk_start[:n_docs],
        doc_n_chunks=art.doc_n_chunks[:n_docs],
        doc_ids=art.doc_ids[:n_docs], urls=art.urls[:n_docs],
        titles=art.titles[:n_docs], domains=art.domains[:n_docs],
        snippets=art.snippets[:n_docs],
        window_texts=[windows[i] for i in range(n_ch)],
    )


def reset_launches():
    for k in cuda_lib.KERNELS:
        k.launches = 0


def read_launches():
    return {k.name: k.launches for k in cuda_lib.KERNELS}


def check_batch_launches(counts, batches, n_buckets, what, stats=True):
    """``batches`` device batches of the slot path launched one BM25 kernel
    each and the stats kernel once per bucket (none with the int8 bank)."""
    bm25 = sum(n for k, n in counts.items() if k != "dense_stats")
    want4 = n_buckets * batches if stats else 0
    check(bm25 == batches and counts["dense_stats"] == want4,
          f"{what}: launches {counts} for {batches} device batches "
          f"({n_buckets} buckets)")


def serving_phase(seed, eng, art, words, dfs, cfg, enc, slot_batches, name,
                  smi):
    """Phase 5d, the serving surface over the phase-3 slot engine:
      (1) the C++ data plane (``serve_fastpath``, pipeline 2) with
          fragments of real-length window texts: 16 single queries equal
          to ``search_batch_indices`` and ``search_batch``, then 4,000
          requests over 64 connections from a separate process (256
          distinct queries), launches checked against its device batches;
      (2) the asyncio control plane (``SearchService`` in a thread): 16
          sequential /api/search equal to (1), 64 clients x 8 requests
          from a separate process (coalescing > 1), /api/health, /stats,
          /rerank, /batch_search and /profile (a trace with CUDA kernels);
      (3) ``bank_dtype="int8"`` at B = 1 / 16 / 64: kernel 4 never, the
          branch's BM25 kernel once; top-10 near the bf16 engine's and
          equal to the CPU port's int8 engine (B = 1, 16);
      (4) the CLI booted as a subprocess on a saved 10,000-doc cut with
          --int8-bank and --fastpath-port: both planes, the same docs, a
          clean exit on SIGTERM.
    The data plane's load runs again with pipeline 1 (one dispatcher).
    Returns the launch counts of (1)-(3)."""
    t_phase = time.time()
    launches = {}
    n_buckets = len(eng.didx.buckets)
    rng = np.random.default_rng(seed + 5)
    pool = []
    while len(pool) < 256:
        for q in query_strings(rng, dfs, words, 64):
            if q.strip() and q not in pool and len(pool) < 256:
                pool.append(q)
    bodies = [json.dumps({"query": q, "top_k": 10}) for q in pool]
    windows = SyntheticWindows(seed, words, dfs, art.n_chunks)
    # the phase-3 slot engine, its window texts at real length: a shallow
    # copy shares the device index and everything else
    eng_w = copy.copy(eng)
    eng_w.art = dataclasses.replace(art, window_texts=windows)
    eng_w.times = StageTimes()

    # (1) the data plane, pipeline 2 (then 1 on the same load) ------------
    t0 = time.time()
    frags = build_fragments(eng_w.art)
    log(f"serving: data-plane fragments of {art.n_chunks} windows at real "
        f"length built in {time.time() - t0:.1f} s")
    fast_docs = {}
    for pipeline in (2, 1):
        fast = serve_fastpath(eng_w, free_port(), pipeline=pipeline,
                              fragments=frags)
        try:
            if pipeline == 2:
                for q in pool[:16]:
                    st, body = http_json(fast.port, "POST", "/api/search",
                                         {"query": q, "top_k": 10})
                    check(st == 200, f"data plane {q!r}: status {st}")
                    idx = eng_w.search_batch_indices([q], top_k=10)[0]
                    want = [{"doc_id": str(art.doc_ids[int(art.chunk_doc[w])]),
                             "score": sc} for w, sc in idx]
                    same_docs(body["documents"], want, f"data plane {q!r}")
                    rows = [Row(art.doc_ids[int(art.chunk_doc[w])], sc, w)
                            for w, sc in idx]
                    same_top(rows, eng_w.search_batch([q], top_k=10)[0],
                             f"data plane {q!r} vs search_batch")
                    fast_docs[q] = body["documents"]
                check(any(fast_docs.values()), "data plane: every result empty")
                log("  data plane: 16 single queries equal to "
                    "search_batch_indices (doc ids, scores) and to "
                    "search_batch (same_top)")
            reset_launches()
            eng_w.times = StageTimes()
            before = fast.stats()
            res = data_plane_load(fast.port, bodies)
            after = fast.stats()
            counts = read_launches()
            host = {k: v["mean_ms"] for k, v in eng_w.times.report().items()}
        finally:
            fast.stop()
        batches = after["batches"] - before["batches"]
        queries = after["batched_queries"] - before["batched_queries"]
        check(res["errors"] == 0 and res["requests"] == 4000,
              f"data plane load: {res}")
        check_batch_launches(counts, batches, n_buckets,
                             f"data plane pipeline {pipeline} load")
        launches[f"data plane pipeline {pipeline}, 4000 requests"] = counts
        log(f"  data plane pipeline {pipeline}, 64 connections, 4000 requests "
            f"over 256 distinct queries (client in a separate process): "
            f"{res['qps']:.1f} q/s, p50 {res['p50_ms']:.3f} / p95 "
            f"{res['p95_ms']:.3f} / p99 {res['p99_ms']:.3f} ms, 0 errors; "
            f"{batches} device batches, {queries / max(batches, 1):.2f} "
            f"queries a batch; server stats {json.dumps(after)}; launches "
            f"{counts}; host stage means (ms) {host}; on {name} ({smi})")
    # the same load with a canned ranking: the C++ server and the client
    # alone, the device and the interpreter out of the loop
    stub = make_server(free_port(), max_batch=cfg.query_batch_size,
                       default_top_k=10)
    stub.load_fragments(frags)
    attach_stub(stub, art.n_chunks, k=10)
    stub.start()
    try:
        res = data_plane_load(stub.port, bodies)
        st = stub.stats()
    finally:
        stub.stop()
    check(res["errors"] == 0 and res["requests"] == 4000,
          f"data plane stub load: {res}")
    log(f"  data plane with a canned ranking (no device, no interpreter), "
        f"the same load: {res['qps']:.1f} q/s, p50 {res['p50_ms']:.3f} / "
        f"p99 {res['p99_ms']:.3f} ms; server stats {json.dumps(st)}")

    # (2) the control plane ------------------------------------------------
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    qpath = os.path.join(build, "serve_queries.txt")
    with open(qpath, "w", encoding="utf-8") as f:
        f.writelines(f"{i + 1}\t{q}\n" for i, q in enumerate(pool[:10]))
    svc = SearchService(eng_w, queries_path=qpath, query_cache_size=0,
                        results_path=os.path.join(build, "serve_results.txt"),
                        trace_root=os.path.join(build, "serve_profile"))
    srv = ServerThread(svc.build_app()).start()
    try:
        lat = []
        for q in pool[:16]:
            t0 = time.perf_counter()
            st, body = http_json(srv.port, "POST", "/api/search",
                                 {"query": q, "top_k": 10, "query_id": "q"})
            lat.append(time.perf_counter() - t0)
            check(st == 200 and list(body) == ["llm_response", "documents"],
                  f"control plane {q!r}: {st}")
            for i, d in enumerate(body["documents"], 1):
                check(list(d) == ["query_id", "rank", "url", "score", "title",
                                  "snippet", "domain", "doc_id"]
                      and d["rank"] == i and d["query_id"] == "q",
                      f"control plane {q!r}: row {d}")
            same_docs(body["documents"], fast_docs[q],
                      f"control plane vs data plane {q!r}")
        summ = []
        for q in pool[:16]:
            wins = [r.window_text for r in eng_w.search(q, top_k=10)]
            t0 = time.perf_counter()
            svc.summarizer.generate_summary(q, wins)
            summ.append(time.perf_counter() - t0)
        log(f"  control plane: 16 sequential /api/search, the reference's "
            f"schema, the data plane's docs; p50 "
            f"{np.median(lat) * 1e3:.3f} ms; the extractive llm_response of "
            f"a request's 10 windows alone: p50 {np.median(summ) * 1e3:.3f} "
            f"ms on the host")
        reset_launches()
        b0 = svc.batcher.stats()
        res = load_test.in_subprocess("http_load", port=srv.port,
                                      bodies=bodies, n_clients=64,
                                      n_requests=512)
        counts = read_launches()
        st, tm = http_json(srv.port, "GET", "/api/timings")
        b1 = tm["online_batching"]
        batches = b1["device_batches"] - b0["device_batches"]
        check(res["errors"] == 0 and res["requests"] == 512,
              f"control plane load: {res}")
        check(st == 200 and b1["coalescing_ratio"] > 1,
              f"control plane: coalescing {b1}")
        check_batch_launches(counts, batches, n_buckets, "control plane load")
        launches["control plane, 512 requests"] = counts
        log(f"  control plane, 64 clients x 8 requests (a separate process): "
            f"{res['qps']:.1f} q/s, p50 {res['p50_ms']:.3f} / p95 "
            f"{res['p95_ms']:.3f} / p99 {res['p99_ms']:.3f} ms, 0 errors; "
            f"{batches} device batches, {512 / max(batches, 1):.2f} requests "
            f"a batch; /api/timings online_batching {json.dumps(b1)}; "
            f"launches {counts}; on {name} ({smi})")
        st, h = http_json(srv.port, "GET", "/api/health")
        check(st == 200 and h == {"status": "healthy",
                                  "search_engine_ready": True}, f"health {h}")
        st, stats = http_json(srv.port, "GET", "/api/stats")
        check(st == 200 and stats["total_documents"] == art.n_docs,
              f"stats {stats}")
        stage1 = eng_w.bm25_search(pool[0], top_k=100)
        st, rr = http_json(srv.port, "POST", "/api/rerank", {
            "doc_ids": [r["doc_id"] for r in stage1],
            "similarities": [r["score"] for r in stage1], "query": pool[0]})
        sc = [d["similarity_score"] for d in rr.get("document_scores", [])]
        check(st == 200 and sc and sc == sorted(sc, reverse=True),
              f"rerank: {st}")
        st, bs = http_json(srv.port, "POST", "/api/batch_search")
        check(st == 200 and bs["total_queries"] == 10
              and bs["total_results"] > 0, f"batch_search: {st}")
        st, pr = http_json(srv.port, "POST", "/api/profile",
                           {"queries": pool[:16], "label": "serving"})
        check(st == 200 and os.path.abspath(pr["trace_dir"]).startswith(build),
              f"profile: {st} {pr}")
        traces = sorted(f for f in os.listdir(pr["trace_dir"])
                        if f.startswith("trace_"))
        with open(os.path.join(pr["trace_dir"], traces[-1])) as f:
            cats = collections.Counter(
                e.get("cat") for e in json.load(f)["traceEvents"])
        check(cats.get("kernel", 0) > 0, f"profile trace: no CUDA kernel "
              f"events ({dict(cats)})")
        log(f"  control plane: /api/health, /api/stats ({stats}), /api/rerank "
            f"({len(sc)} rows from {len(stage1)} stage-1 candidates), "
            f"/api/batch_search ({bs['total_results']} rows), /api/profile "
            f"({pr['wall_seconds']} s; {traces[-1]}: {cats['kernel']} CUDA "
            f"kernel events of {sum(cats.values())})")
    finally:
        srv.stop()

    # (3) the int8 bank ----------------------------------------------------
    t0 = time.time()
    eng8 = SearchEngine(art, enc, cfg, bank_dtype="int8")
    torch.cuda.synchronize()

    def bank_mb(e):
        return sum(t.numel() * t.element_size() for b in e.didx.bucket_emb
                   for t in (b if isinstance(b, tuple) else (b,))) / 1e6

    check(bank_mb(eng8) < 0.55 * bank_mb(eng), "int8 bank does not halve")
    log(f"  int8 engine built in {time.time() - t0:.1f} s: bank "
        f"{bank_mb(eng8):.1f} MB (bf16 {bank_mb(eng):.1f} MB), resident "
        f"{eng8.didx.resident_bytes() / 1e6:.1f} MB (bf16 engine "
        f"{eng.didx.resident_bytes() / 1e6:.1f} MB)")
    want_bm25 = {"B=1": "bm25_slots", "B=16": "bm25_slots_udedup_sublane",
                 "B=64": "bm25_slots_udedup_i8"}
    res8 = {}
    for key, qs in slot_batches.items():
        reset_launches()
        res8[key] = eng8.search_batch(qs, top_k=10)
        counts = read_launches()
        for k, n in counts.items():
            check(n == int(k == want_bm25[key]),
                  f"int8 {key}: {k} launched {n} times")
        launches[f"int8 {key}"] = counts
        worst = 1.0
        for a, b in zip(eng.search_batch(qs, top_k=10), res8[key]):
            ids_a, ids_b = [r.doc_id for r in a], [r.doc_id for r in b]
            if not ids_a:
                check(not ids_b, f"int8 {key}: results where bf16 has none")
                continue
            ov = len(set(ids_a) & set(ids_b)) / len(ids_a)
            worst = min(worst, ov)
            check(ov >= 0.9, f"int8 {key}: overlap {ov} with bf16")
            sb = {r.doc_id: r.similarity_score for r in b}
            for r in a:
                if r.doc_id in sb:
                    check(abs(r.similarity_score - sb[r.doc_id]) < 0.05,
                          f"int8 {key}: doc {r.doc_id} score vs bf16")
        log(f"  int8 {key}: launches {counts}; top-10 overlap with the bf16 "
            f"engine >= {worst:.2f}, shared docs' scores within 0.05")
    t0 = time.time()
    cpu8 = SearchEngine(art, enc, cfg, bank_dtype="int8", device="cpu")
    for key in ("B=1", "B=16"):
        want = cpu8.search_batch(slot_batches[key], top_k=10)
        for i, (g, w) in enumerate(zip(res8[key], want)):
            same_top(g, w, f"int8 card vs cpu {key} q{i}")
    qv = torch.as_tensor(eng8.encode_queries(slot_batches["B=16"]))
    raw_card = ops._int8_product(
        eng8.didx.bucket_emb[0][0].flatten(0, 1),
        ops.quantize_queries_int8(qv.to(eng8.device))[0])
    raw_cpu = ops._int8_product(cpu8.didx.bucket_emb[0][0].flatten(0, 1),
                                ops.quantize_queries_int8(qv)[0])
    check(torch.equal(raw_card.cpu(), raw_cpu),
          "int8: the card's s32 product differs from the cpu's")
    log(f"  int8 card == cpu int8 engine on B=1 and B=16 (same_top), s32 "
        f"product of bucket 0 equal bit for bit "
        f"({time.time() - t0:.1f} s)")
    del cpu8
    for key, qs in slot_batches.items():
        p50 = {}
        for label, e in (("bf16", eng), ("int8", eng8)):
            ts = []
            for _ in range(10):
                t0 = time.perf_counter()
                e.search_batch(qs, top_k=10)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            p50[label] = float(np.median(ts)) * 1e3
        busy = {}
        for label, e in (("bf16", eng), ("int8", eng8)):
            prof = profile_call(lambda: e.search_batch(qs, top_k=10))
            busy[label] = None if prof is None else prof["device_busy_ms"]
        log(f"  int8 vs bf16 search_batch {key}: p50 {p50['int8']:.3f} vs "
            f"{p50['bf16']:.3f} ms, device busy {busy['int8']} vs "
            f"{busy['bf16']} ms on {name} ({smi})")
    del eng8

    # (4) the CLI ----------------------------------------------------------
    t0 = time.time()
    idx_dir = os.path.join(build, "serve_index")
    cut = cut_artifacts(art, SERVE_CUT_DOCS, windows)
    save_artifacts(cut, idx_dir)
    log(f"  CLI: {SERVE_CUT_DOCS}-doc cut ({cut.n_chunks} windows, "
        f"{cut.post_docs.size} postings) saved in {time.time() - t0:.1f} s")
    port, fport = free_port(), free_port()
    with open(os.path.join(build, "serve_cli.log"), "wb") as logf:
        t0 = time.time()
        proc = subprocess.Popen(
            [sys.executable, "-m", "modern_search_engines_project_tpu_torch."
             "serving", "--index", idx_dir, "--host", "127.0.0.1", "--port",
             str(port), "--fastpath-port", str(fport), "--int8-bank",
             "--trace-root", os.path.join(build, "serve_cli_profile")],
            stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT)
        try:
            deadline = time.time() + 300
            while True:
                check(proc.poll() is None and time.time() < deadline,
                      f"CLI: not healthy (rc {proc.poll()}), see "
                      "build/serve_cli.log")
                try:
                    if http_json(port, "GET", "/api/health", timeout=5)[0] \
                            == 200:
                        break
                except OSError:
                    time.sleep(0.5)
            boot_s = time.time() - t0
            n_docs = 0
            for q in pool[:8]:
                st_f, f_body = http_json(fport, "POST", "/api/search",
                                         {"query": q, "top_k": 10})
                st_c, c_body = http_json(port, "POST", "/api/search",
                                         {"query": q, "top_k": 10})
                check(st_f == st_c == 200, f"CLI {q!r}: {st_f} / {st_c}")
                same_docs(f_body["documents"], c_body["documents"],
                          f"CLI data plane vs control plane {q!r}")
                n_docs += len(c_body["documents"])
            check(n_docs > 0, "CLI: every result empty")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            check(rc in (0, -signal.SIGTERM), f"CLI: exit code {rc} on SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    log(f"  CLI --index ({SERVE_CUT_DOCS}-doc cut) --int8-bank --fastpath-port: "
        f"healthy "
        f"{boot_s:.1f} s after start (warmup included); 8 queries, both "
        f"planes the same docs ({n_docs} rows); exit code {rc} on SIGTERM")
    log(f"  serving phase: {time.time() - t_phase:.1f} s")
    return launches


# ---- phase 5e: the offline path (training, checkpoints, the build) ---------

# Training, card against the port on the CPU: the tolerances of
# tests/test_torch_train.py (the port against the reference on the CPU):
# (loss atol, loss rtol, gradient leaf tolerance of its largest magnitude)
# per dtype: f32 losses to 1e-5 and leaves to 1e-4; bf16 losses to 5e-3 of
# their value and leaves to 5e-2 (bf16 activations an ulp apart, times
# 1 / temperature in the InfoNCE logits).
# The bf16 leaves are held on a tree drawn from the seed and not on a
# trained one: in a trained tower (runs/encoder-real) attention is peaky,
# and bf16 rounding of q and k moves the scores, so the q/k columns of the
# attention products' gradients (and the ln1 before them) land 10-50 % of
# their largest magnitude from the f32 gradient on the CPU port as on the
# card, each device its own way; no fixed tolerance then tells a right
# card from a wrong one.  There the bf16 loss is held, the f32 step holds
# every leaf, and the leaves' bf16 distances are printed.
TRAIN_TOL = {"float32": (1e-5, 0.0, 1e-4), "bfloat16": (0.0, 5e-3, 5e-2)}
# The flagship recipe's shapes (tools/real_encoder.py): stage A in-batch
# InfoNCE at B = 256, stage B with one mined negative a row at B = 160,
# L = 128; STEPS steps a stage, then TIMED_STEPS timed warm steps a loss.
STAGE_A_B, STAGE_B_B, TRAIN_L, STEPS, TIMED_STEPS = 256, 160, 128, 10, 3
BUILD_DOCS, BUILD_SHARD = 2_000, 512
# train_cli's synthetic pairs (its default is 2,048; 512 keeps its 12L/768d
# cosine run to a dozen steps)
CLI_PAIRS = 512
# An f16 checkpoint against the f32 tower it was saved from: ~1/16 of the
# weights round to another bf16 value through f16 (double rounding; more
# among f16 subnormals), so unit embeddings move by up to a few 1e-3
# (5.8e-3, cosine 0.99990, at 2 layers / 64 wide on the CPU); the reload
# itself must equal the f16-rounded tree's embeddings exactly.  The
# cross-encoder's sigmoid scores are held to the same 1e-2.
F16_ATOL, F16_COS = 1e-2, 0.9995
OFFLINE_DIR = os.path.join(ROOT, "build", "offline_smoke")


def train_step_bound(cfg, B, L, towers):
    """Least time of one training step of ``cfg`` on ``towers`` towers of
    B x L tokens: 6 operations a matmul weight a token (forward, and the
    two products of the backward) plus three times the forward's attention
    products (4 x L^2 x dim a sequence and layer), at the bf16 tensor-core
    peak; bytes: f32 parameters, gradients and both Adam moments read and
    written once.  Returns (ms, "bytes" or "operations", operations)."""
    D, Hd = cfg.dim, cfg.dim * cfg.mlp_ratio
    w = cfg.n_layers * (3 * D * D + D * D + 2 * Hd * D + Hd * D)
    n_par = w + cfg.vocab_size * D + (2 * cfg.n_layers + 1) * 2 * D
    tokens = towers * B * L
    ops = 6 * w * tokens + 3 * 4 * towers * B * L * L * D * cfg.n_layers
    ms, by = bound(n_par * 4 * 8, ops, BF16_OPS)
    return ms, by, ops


def f16_rounded(tree):
    """A reference-form tree as an f16 checkpoint holds it, in f32."""
    if isinstance(tree, dict):
        return {k: f16_rounded(v) for k, v in tree.items()}
    return tree.astype(np.float16).astype(np.float32)


def tree_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def loss_and_grads(trainer, batch):
    trainer.model.zero_grad(set_to_none=True)
    loss = trainer.loss(trainer.upload_batch(batch))
    loss.backward()
    g = {n: p.grad for n, p in trainer.model.named_parameters()}
    return float(loss.detach()), tree_leaves(params_to_reference(g))


def time_train_steps(trainer, batch, what, name, smi):
    """Warm step time (host clock around a synchronised step, median of
    TIMED_STEPS), tokens/s, one torch.profiler trace of a step, the
    bound.  Each timed step is a real optimizer step."""
    B, L = batch["ids1"].shape
    towers = 3 if "ids3" in batch else 2
    ts = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(trainer.step(batch))
        ts.append(time.perf_counter() - t0)
    check(np.isfinite(loss), f"{what}: loss {loss}")
    step = float(np.median(ts))
    real = int(sum(batch[f"mask{i}"].sum() for i in range(1, towers + 1)))
    prof = profile_call(lambda: trainer.step(batch))
    b_ms, b_by, ops = train_step_bound(trainer.enc_cfg, B, L, towers)
    row = {"loss": trainer.cfg.loss, "B": B, "L": L, "towers": towers,
           "step_ms": step * 1e3, "steps_ms": [t * 1e3 for t in ts],
           "tokens_per_s": towers * B * L / step,
           "real_tokens_per_s": real / step, "bound_ms": b_ms,
           "bound_by": b_by, "bound_tflop": ops / 1e12,
           "share_of_bound": b_ms / (step * 1e3)}
    if prof is None:
        row["device_busy_ms"] = "not measured (no device events)"
    else:
        row.update(device_busy_ms=prof["device_busy_ms"],
                   device_events=prof["device_events"],
                   idle_share=prof["idle_share"],
                   idle_share_of_step=1 - prof["device_busy_ms"] / (step * 1e3),
                   busy_share_of_bound=b_ms / prof["device_busy_ms"],
                   top_device_ms=prof["top_device_ms"])
    log(f"  train step {what} on {name} ({smi}): {json.dumps(row)}")


def step_on_both(tree, triples, dtype):
    """The full-width tower (``infonce_hn``) on the card and on the port on
    the CPU, same tree and batch: (card trainer, host batch, (loss,
    gradient leaves) on the card, the same on the CPU)."""
    cfg = dataclasses.replace(EncoderConfig(), dtype=dtype)
    tcfg = TrainConfig(loss="infonce_hn", max_len=32)
    card = Trainer(cfg, tcfg).init(10, params=tree)
    cpu = Trainer(cfg, tcfg, device="cpu").init(10, params=tree)
    batch = card.encode_pairs(triples)
    return card, batch, loss_and_grads(card, batch), loss_and_grads(cpu, batch)


def worst_leaf(got, want):
    """(largest |got - want| over a leaf's largest |want|, that leaf)."""
    worst, worst_k = 0.0, None
    for k, w in want.items():
        rel = float(np.abs(got[k] - w).max() / np.abs(w).max())
        if rel > worst:
            worst, worst_k = rel, k
    return worst, worst_k


def hold_step(what, dtype, card, cpu, leaves=True):
    """The card's (loss, leaves) against the CPU port's under TRAIN_TOL;
    the gradient leaves only with ``leaves``.  Returns the errors."""
    (la, ga), (lb, gb) = card, cpu
    l_abs, l_rel, g_tol = TRAIN_TOL[dtype]
    check(np.isfinite(la) and abs(la - lb) <= l_abs + l_rel * abs(lb),
          f"{what} {dtype}: loss {la} vs {lb}")
    worst, worst_k = worst_leaf(ga, gb)
    if leaves:
        check(worst <= g_tol, f"{what} {dtype}: gradient {worst_k} off by "
              f"{worst} of its largest magnitude (> {g_tol})")
    return {"loss_card": la, "loss_cpu": lb, "loss_abs_err": abs(la - lb),
            "grad_worst_rel_err": worst, "grad_worst_leaf": worst_k}


def small_step_cost(card, batch, tree):
    """A rate-0 step (the schedule's first) that must leave the parameters
    as they were, then the host's cost of a step: at B = 8, L = 32 the card
    runs each of the step's operations faster than the host enqueues it,
    so a synchronised step's wall time is the host's enqueue of the same
    operations."""
    card.update()
    qkv = card.model.blocks[0].attn.qkv.detach().cpu().numpy()
    check(np.array_equal(qkv, tree["block0"]["attn"]["qkv"]["kernel"]),
          f"step card {card.enc_cfg.dtype}: the rate-0 step moved the "
          f"parameters")
    card.step(batch)
    ts = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.step(batch)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    prof = profile_call(lambda: card.step(batch))
    n_ops = None if prof is None else prof["device_events"]
    wall = float(np.median(ts)) * 1e3
    return {"small_step_wall_ms": wall, "small_step_device_ops": n_ops,
            "small_step_busy_ms": None if prof is None
            else prof["device_busy_ms"],
            "host_us_per_op": None if n_ops is None else wall * 1e3 / n_ops}


def check_step_card_vs_cpu(trained, drawn, triples):
    """(b): one loss and its gradients of the full-width tower on the card
    and on the port on the CPU, same tree and batch:
      * the trained tree in f32: the loss and every gradient leaf within
        TRAIN_TOL;
      * the trained tree in bf16: the loss within TRAIN_TOL; the leaves'
        distances are printed, beside each device's distance from the f32
        gradient, and not held (the note at TRAIN_TOL says why);
      * ``drawn`` (weights drawn from the seed, the same widths) in bf16:
        the loss and every gradient leaf within TRAIN_TOL;
    then a rate-0 step and the small step's host cost in each dtype.
    Returns the errors and costs."""
    out = {}
    card, batch, ga, gb = step_on_both(trained, triples, "float32")
    out["trained float32"] = hold_step("step card vs cpu, trained tree",
                                       "float32", ga, gb)
    out["trained float32"].update(small_step_cost(card, batch, trained))
    f32 = gb[1]
    del card
    card, batch, ga, gb = step_on_both(trained, triples, "bfloat16")
    row = hold_step("step card vs cpu, trained tree", "bfloat16", ga, gb,
                    leaves=False)
    for who, g in (("card", ga[1]), ("cpu", gb[1])):
        row[f"{who}_bf16_vs_f32_worst_rel_err"], row[
            f"{who}_bf16_vs_f32_worst_leaf"] = worst_leaf(g, f32)
    row.update(small_step_cost(card, batch, trained))
    out["trained bfloat16"] = row
    del card
    _, _, ga, gb = step_on_both(drawn, triples, "bfloat16")
    out["drawn bfloat16"] = hold_step("step card vs cpu, drawn tree",
                                      "bfloat16", ga, gb)
    return out


def training_phase(seed, words, dfs, cfg, name, smi):
    """Phase 5e, the offline path at the flagship's full width
    (``EncoderConfig()``: 12 layers, 768 wide; warm-started from
    runs/encoder-real where that checkpoint is present, else weights drawn
    from ``seed``):
      (a) stage A ``infonce`` at B = 256, L = 128 on (query, window) pairs
          of the phase-3 corpus (window text from ``SyntheticWindows``, the
          query its 3 rarest words), ``mine_hn_triples`` with the trained
          tower, stage B ``infonce_hn`` at B = 160, and ``cosine`` steps
          at B = 256; warm step ms, tokens/s, the bound, device busy and
          idle share of one traced step, peak memory;
      (b) one full-width step (B = 8, L = 32, ``infonce_hn``) on the card
          against the port on the CPU: from the trained tree in f32, loss
          and every gradient leaf within TRAIN_TOL; in bf16 the loss, the
          leaves printed beside each device's distance from f32; from a
          tree drawn from ``seed`` in bf16, loss and every leaf within
          TRAIN_TOL (``check_step_card_vs_cpu``);
      (c) ``save_encoder`` in f16, reloaded twice by the port's reader:
          one digest, embeddings equal to those of the f16-rounded tree
          and within f16 rounding of the trained tower's (F16_ATOL,
          cosine F16_COS);
      (d) ``BuildPipeline`` with the reloaded encoder over BUILD_DOCS docs
          in shards of BUILD_SHARD; one shard deleted and the build rerun
          (resume): the same artifacts; then the index CLI as a subprocess
          over a ``CrawlStore`` of the same docs with ``--encoder <ckpt>``:
          the same artifacts;
      (e) ``search_batch`` on the built index with the trained query
          encoder at B = 1 / 16 / 64 (launches checked as in phase 5,
          top-10 against the numpy oracle fed the card's query vectors);
      (f) ``train_cross_encoder`` at ``CE_CFG`` (B = 16, L = 192), ``save``
          and ``from_checkpoint``; ``save_decoder`` and ``load_decoder``
          (runs/summarizer-real where present, else ``DEC_CFG`` from the
          seed), the same greedy tokens; ``train_cli`` at its defaults
          but for CLI_PAIRS synthetic pairs, as a subprocess (12L/768d, 5
          negatives).
    Returns the launch counts of the (e) batches."""
    t_phase = time.time()
    shutil.rmtree(OFFLINE_DIR, ignore_errors=True)
    os.makedirs(OFFLINE_DIR)
    rng = np.random.default_rng(seed + 6)
    enc_cfg = EncoderConfig()
    real = os.path.join(ROOT, "runs", "encoder-real")
    t0 = time.time()
    if os.path.exists(os.path.join(real, "params.msgpack")):
        tree, real_cfg = load_encoder(real)
        check(real_cfg == enc_cfg, f"runs/encoder-real: {real_cfg}")
        start = "runs/encoder-real"
    else:
        tree = init_reference_params(
            enc_cfg, lambda s: rng.standard_normal(s, dtype=np.float32))
        start = f"weights drawn from seed {seed} (runs/ absent)"
    log(f"training: {enc_cfg}; warm start from {start} in "
        f"{time.time() - t0:.1f} s")

    # (a) the recipe's two stages, then cosine steps
    n_pairs = STAGE_A_B * STEPS
    windows = SyntheticWindows(seed + 6, words, dfs, n_pairs)
    df_of = dict(zip(words, dfs))
    pairs = []
    for i in range(n_pairs):
        w = windows[i]
        pairs.append((" ".join(sorted(set(w[:-1].replace(". ", " ").split()),
                                      key=df_of.get)[:3]), w))
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(enc_cfg, TrainConfig(loss="infonce", batch_size=STAGE_A_B,
                                      max_len=TRAIN_L, learning_rate=2e-5))
    tr.init(STEPS + TIMED_STEPS + 1, params=tree)
    t0 = time.time()
    losses_a = tr.train([(q, p, 1.0) for q, p in pairs])
    t_a = time.time() - t0
    check(len(losses_a) == STEPS and np.isfinite(losses_a).all(),
          f"stage A losses {losses_a}")
    time_train_steps(
        tr, tr.encode_pairs([(q, p, 1.0) for q, p in pairs[:STAGE_A_B]]),
        "stage A infonce", name, smi)
    t0 = time.time()
    hn = mine_hn_triples(tr.to_encoder(batch_size=256), pairs)
    t_mine = time.time() - t0
    check(len(hn) >= STAGE_B_B * STEPS, f"mined {len(hn)} triples")
    trained = tr.params
    del tr
    tr_b = Trainer(enc_cfg, TrainConfig(loss="infonce_hn",
                                        batch_size=STAGE_B_B, max_len=TRAIN_L))
    tr_b.init(STEPS + TIMED_STEPS + 1, params=trained)
    t0 = time.time()
    losses_b = tr_b.train(hn[: STAGE_B_B * STEPS])
    t_b = time.time() - t0
    check(len(losses_b) == STEPS and np.isfinite(losses_b).all(),
          f"stage B losses {losses_b}")
    time_train_steps(
        tr_b, tr_b.encode_pairs(hn[:STAGE_B_B]), "stage B infonce_hn", name,
        smi)
    trained = tr_b.params
    del tr_b
    tr_c = Trainer(enc_cfg, TrainConfig(loss="cosine", batch_size=STAGE_A_B,
                                        max_len=TRAIN_L))
    tr_c.init(TIMED_STEPS + 1, params=trained)
    cos_trip = [(q, p, 1.0) if i % 2 else (q, pairs[i - 1][1], 0.0)
                for i, (q, p) in enumerate(pairs[:STAGE_A_B])]
    time_train_steps(tr_c, tr_c.encode_pairs(cos_trip), "cosine", name, smi)
    del tr_c
    peak = torch.cuda.max_memory_allocated()
    log(f"  stage A: {STEPS} steps in {t_a:.1f} s (pre-tokenizing included), "
        f"losses {[round(x, 4) for x in losses_a]}; mining {len(pairs)} "
        f"queries against {len(set(p for _, p in pairs))} passages: "
        f"{t_mine:.2f} s, {len(hn)} triples; stage B: {STEPS} steps in "
        f"{t_b:.1f} s, losses {[round(x, 4) for x in losses_b]}; peak device "
        f"memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")

    # (b) one step on the card against the port on the CPU
    t0 = time.time()
    small = [(q[:60], p[:300], n[:300]) for q, p, n in hn[:8]]
    drawn_rng = np.random.default_rng(seed + 7)
    drawn = init_reference_params(
        enc_cfg, lambda s: drawn_rng.standard_normal(s, dtype=np.float32))
    errs = check_step_card_vs_cpu(trained, drawn, small)
    del drawn
    log(f"  one full-width step (B = 8, L = 32, infonce_hn), card vs the "
        f"port on the cpu (tolerances {TRAIN_TOL}): {json.dumps(errs)} "
        f"({time.time() - t0:.1f} s)")

    # (c) save in f16, reload
    ckpt = os.path.join(OFFLINE_DIR, "encoder")
    t0 = time.time()
    save_encoder(trained, enc_cfg, ckpt, dtype="float16")
    t_save = time.time() - t0
    live = TorchEncoder(enc_cfg, params=trained)
    held = TorchEncoder(enc_cfg, params=f16_rounded(trained))
    del trained
    enc = TorchEncoder.from_checkpoint(ckpt)
    again = TorchEncoder.from_checkpoint(ckpt)
    check(enc.params_digest() == again.params_digest() == held.params_digest(),
          "reloaded checkpoint: digests differ")
    texts = [q for q, _ in pairs[:32]] + [windows[i] for i in range(32)]
    got, want = enc.encode_batch(texts), live.encode_batch(texts)
    check(np.array_equal(got, again.encode_batch(texts))
          and np.array_equal(got, held.encode_batch(texts)),
          "the reloads and the f16-rounded tree embed differently")
    e = float(np.abs(got - want).max())
    cos = float((got * want).sum(1).min())
    check(e <= F16_ATOL and cos >= F16_COS,
          f"reloaded encoder vs trained: max |d| {e}, min cos {cos}")
    del live, again, held
    log(f"  save_encoder f16: "
        f"{os.path.getsize(os.path.join(ckpt, 'params.msgpack')) / 1e6:.1f} "
        f"MB in {t_save:.2f} s; reloaded twice: digest "
        f"{enc.params_digest()}, embeddings equal to the f16-rounded tree's "
        f"and within max |d| {e:.6f}, min cos {cos:.6f} of the trained "
        f"tower's")

    # (d) the sharded build, its resume, and the CLI
    docs = synthetic_docs(rng, words, dfs, BUILD_DOCS, first_id=1)
    out = os.path.join(OFFLINE_DIR, "pipeline")
    t0 = time.time()
    built = BuildPipeline(enc, out, cfg, shard_size=BUILD_SHARD).build(docs)
    t_build = time.time() - t0
    check(built.n_docs == BUILD_DOCS and np.isfinite(built.chunk_emb).all()
          and built.encoder_meta["ckpt"] == ckpt,
          f"pipeline: {built.n_docs} docs, meta {built.encoder_meta}")
    os.remove(os.path.join(out, "shards", "shard_00002.pkl"))
    t0 = time.time()
    resumed = BuildPipeline(enc, out, cfg, shard_size=BUILD_SHARD).build(docs)
    t_resume = time.time() - t0
    same_build(resumed, built, "resumed build")
    db = os.path.join(OFFLINE_DIR, "crawl.sqlite")
    store = CrawlStore(db)
    store.upsert_documents({"url": d.url, "title": d.title, "text": d.text}
                           for d in docs)
    store.close()
    cli_out = os.path.join(OFFLINE_DIR, "cli_index")
    t0 = time.time()
    run = subprocess.run(
        [sys.executable, "-m", "modern_search_engines_project_tpu_torch.index",
         "--db", db, "--out", cli_out, "--shard-size", str(BUILD_SHARD),
         "--encoder", ckpt], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    t_cli = time.time() - t0
    check(run.returncode == 0, f"index CLI: exit {run.returncode}: "
          f"{run.stderr[-2000:]}")
    same_build(load_artifacts(cli_out), built, "index CLI")
    log(f"  BuildPipeline on {name} ({smi}): {BUILD_DOCS} docs, "
        f"{built.n_chunks} windows, {BUILD_DOCS // BUILD_SHARD + 1} shards of "
        f"{BUILD_SHARD}: {t_build:.2f} s ({BUILD_DOCS / t_build:.1f} docs/s, "
        f"{built.n_chunks / t_build:.1f} windows/s); one shard deleted and "
        f"resumed in {t_resume:.2f} s, the same artifacts; the index CLI "
        f"(--encoder <ckpt>) as a subprocess: {t_cli:.1f} s wall, the same "
        f"artifacts")

    # (e) serve the built index with the trained query encoder
    eng = SearchEngine(built, enc, cfg)
    batches = {f"B={B}": rare_terms_queries(docs, words, dfs, rng, B)
               for B in (1, 16, 64)}
    tids, _, _ = eng.prepare_queries(batches["B=64"])
    n_u = int(np.unique(tids[tids >= 0]).size)
    check(128 < n_u <= 1024, f"built index B=64: {n_u} distinct terms")
    want_bm25 = {"B=1": "bm25_slots", "B=16": "bm25_slots_udedup_sublane",
                 "B=64": "bm25_slots_udedup_i8"}
    results, launches = drive(eng, batches, want_bm25, "built index")
    for key, qs in batches.items():
        _, _, processed = eng.prepare_queries(qs)
        qn = eng.encode_queries(processed).cpu().numpy()
        same_as_oracle(built, None, cfg, results[key], qs[:3],
                       f"built index {key}", qvecs=qn)
    log("  built index served at B = 1, 16, 64: launches as in phase 5, "
        "top-10 == numpy oracle (the card's query vectors) on 3 queries "
        "of each batch")
    del eng, enc

    other_trainers(seed, pairs, name, smi)
    log(f"  training and build phase: {time.time() - t_phase:.1f} s")
    return launches


def same_build(got, want, what):
    """Two builds of the same docs with the same encoder on the card: every
    array and list equal, embeddings to 1e-6."""
    for f in ("indptr", "post_docs", "post_impact", "idf", "df", "doc_len",
              "chunk_doc", "doc_chunk_start", "doc_n_chunks"):
        check(np.array_equal(np.asarray(getattr(got, f)),
                             np.asarray(getattr(want, f))), f"{what}: {f}")
    for f in ("doc_ids", "urls", "titles", "snippets", "window_texts"):
        check(list(getattr(got, f)) == list(getattr(want, f)), f"{what}: {f}")
    check(got.encoder_meta == want.encoder_meta and got.avgdl == want.avgdl,
          f"{what}: encoder_meta {got.encoder_meta}")
    e = float(np.abs(got.chunk_emb - want.chunk_emb).max())
    check(e <= 1e-6, f"{what}: chunk_emb max |d| {e}")


def other_trainers(seed, pairs, name, smi):
    """(f) the cross-encoder trainer and its writer, the decoder's writer,
    and the training CLI."""
    rng = np.random.default_rng(seed + 7)
    trip = []
    for i, (q, p) in enumerate(pairs[:64]):
        trip += [(q, p, 1.0), (q, pairs[(i + 31) % len(pairs)][1], 0.0)]
    t0 = time.time()
    ce, losses = train_cross_encoder(trip, CE_CFG, batch_size=16,
                                     max_len=CE_CFG.max_len, seed=seed)
    t_ce = time.time() - t0
    check(len(losses) == len(trip) // 16 and np.isfinite(losses).all(),
          f"cross-encoder losses {losses}")
    path = os.path.join(OFFLINE_DIR, "cross_encoder")
    ce.save(path)
    a = CrossEncoderReranker.from_checkpoint(path)
    b = CrossEncoderReranker.from_checkpoint(path)
    held = CrossEncoderReranker(CE_CFG, params=f16_rounded(
        cross_encoder_params_to_reference(ce.model)))
    q, cands = trip[0][0], [t for _, t, _ in trip[:32]]
    sa, live = a.rescore(q, cands), ce.rescore(q, cands)
    check(np.array_equal(sa, b.rescore(q, cands))
          and np.array_equal(sa, held.rescore(q, cands)),
          "cross-encoder: the reloads and the f16-rounded tree score "
          "differently")
    e = float(np.abs(sa - live).max())
    check(e <= F16_ATOL, f"cross-encoder reloaded vs trained: {e}")
    log(f"  train_cross_encoder at {CE_CFG.n_layers}L/{CE_CFG.dim}d, B = 16, "
        f"L = {CE_CFG.max_len}: {len(losses)} steps in {t_ce:.1f} s, losses "
        f"{[round(x, 4) for x in losses]}; saved (f16) and reloaded twice: "
        f"scores equal to the f16-rounded tree's, {e:.6f} from the trained "
        f"reranker's")
    del ce, a, b, held

    summ = os.path.join(ROOT, "runs", "summarizer-real")
    if os.path.exists(os.path.join(summ, "params.msgpack")):
        tree, conf = read_checkpoint(summ)
        dcfg = DecoderConfig(**conf)
        vocab = WordVocab.load(os.path.join(summ, "vocab.json"))
        src = "runs/summarizer-real"
    else:  # as a checkpoint holds it: f16-rounded
        dcfg, src = DEC_CFG, f"DEC_CFG drawn from seed {seed}"
        tree = f16_rounded(init_decoder_params(
            dcfg, lambda s: rng.standard_normal(s, dtype=np.float32)))
        vocab = WordVocab.build([" ".join(p for _, p in pairs[:200])],
                                max_words=dcfg.vocab_size)
    model = build_decoder(dcfg, tree, resolve_device())
    path = os.path.join(OFFLINE_DIR, "decoder")
    save_decoder(tree, dcfg, path, vocab=vocab)
    loaded, cfg2, vocab2 = load_decoder(path)
    check(cfg2 == dcfg and vocab2.words == vocab.words,
          "save_decoder: config or vocab changed")
    prompt = vocab.encode(pairs[0][1])[:100]
    want = GreedyGenerator(model).generate([prompt], 48)
    got = GreedyGenerator(loaded).generate([prompt], 48)
    check(np.array_equal(got, want), "save_decoder: greedy tokens changed")
    log(f"  save_decoder of {src} ({dcfg.n_layers}L/{dcfg.dim}d) and "
        f"load_decoder: the same 48 greedy tokens")
    del model, loaded

    t0 = time.time()
    out = os.path.join(OFFLINE_DIR, "cli_encoder")
    run = subprocess.run(
        [sys.executable, "-m",
         "modern_search_engines_project_tpu_torch.models.train_cli",
         "--out", out, "--synthetic", str(CLI_PAIRS)], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    t_cli = time.time() - t0
    check(run.returncode == 0,
          f"train_cli: exit {run.returncode}: {run.stderr[-2000:]}")
    tail = [ln for ln in run.stderr.splitlines() if "INFO:train" in ln]
    cli_enc = TorchEncoder.from_checkpoint(out)
    check(cli_enc.cfg == EncoderConfig()
          and np.isfinite(cli_enc.encode_batch(["castle neckar"])).all(),
          f"train_cli checkpoint: {cli_enc.cfg}")
    log(f"  train_cli at its defaults but --synthetic {CLI_PAIRS} (12L/768d, "
        f"5 negatives, cosine, B = 256) on {name}: exit 0 in {t_cli:.1f} s "
        f"wall; {tail}")


# ---- phase 5f: the sharded backend -------------------------------------------

# Eight shards of the phase-3 index on one card: the counterpart of the
# reference's eight virtual devices.
N_SHARDS = 8
# Scatter stage 1 against the slot kernels: the same f32 products a doc in
# another order (index_add_ keeps none on the card) -> BM25_ATOL beside
# WIDE_RTOL, as the wide batches.
# The multihost demo: two processes of four shards each on one card, over
# gloo; scores printed to 4 places, held as the reference's test holds
# its own (2e-4).
DEMO_ATOL = 2e-4


def same_scored(got, want, tol, what):
    """Two ranked lists of (doc id, score): scores to ``tol``, ids equal
    except where a neighbouring wanted score lies within ``tol``."""
    check(len(got) == len(want), f"{what}: {len(got)} vs {len(want)} rows")
    for i, ((gd, gs), (wd, ws)) in enumerate(zip(got, want)):
        check(abs(gs - ws) <= tol, f"{what}[{i}]: score {gs} vs {ws}")
        if gd != wd:
            near = [abs(want[j][1] - ws) <= tol for j in (i - 1, i + 1)
                    if 0 <= j < len(want)]
            check(any(near), f"{what}[{i}]: doc {gd} vs {wd}")


def bm25_rows(rows):
    return [(r["doc_id"], r["score"]) for r in rows]


def dense_rows(rows):
    return [(r.doc_id, r.similarity_score) for r in rows]


def sharded_batches(eng_n, eng, batches, want, label, n_shards, want_bm25):
    """Each batch through the sharded engine with the counters set to 0
    just before and read just after: the batch's BM25 kernel once a shard,
    kernel 4 once a bucket a shard, nothing else; the top-10 held to the
    one-card engine's ``want``.  Returns the launches keyed like
    ``batches``."""
    n_buckets = len(eng_n.didx.buckets)
    launches = {}
    for key, qs in batches.items():
        reset_launches()
        res = eng_n.search_batch(qs, top_k=10)
        launches[key] = read_launches()
        for k_name, n in launches[key].items():
            w = (n_shards if k_name == want_bm25[key] else
                 n_shards * n_buckets if k_name == "dense_stats" else 0)
            check(n == w, f"{label} {key}: {k_name} launched {n} times, "
                          f"not {w}")
        for i, (g, w) in enumerate(zip(res, want[key])):
            same_top(g, w, f"{label} vs one card {key} q{i}")
    log(f"  {label}: top-10 of B = {', '.join(k[2:] for k in batches)} == "
        f"the one-card engine; launches a batch: "
        f"{ {k: {n: c for n, c in v.items() if c} for k, v in launches.items()} }"
        f"; collectives a call: {eng_n._backend.last_collectives}")
    return launches


def timed_pair(engines, qs, reps=10):
    """p50 ms of ``search_batch`` on each engine, taken in turns."""
    ts = {k: [] for k in engines}
    for _ in range(reps):
        for k, e in engines.items():
            t0 = time.perf_counter()
            e.search_batch(qs, top_k=10)
            torch.cuda.synchronize()
            ts[k].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) * 1e3 for k, v in ts.items()}


def multihost_run(hierarchical):
    """Two processes of the multihost CLI, four shards each on cuda:0 over
    gloo: (their JSON results, wall s)."""
    port = free_port()
    cmd = [sys.executable, "-m",
           "modern_search_engines_project_tpu_torch.parallel.multihost",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
           "--devices-per-process", "4", "--device", "cuda"]
    cmd += ["--hierarchical"] if hierarchical else []
    t0 = time.time()
    procs = [subprocess.Popen(cmd + ["--process-id", str(p)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for p in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            check(p.returncode == 0,
                  f"multihost hierarchical={hierarchical}: exit "
                  f"{p.returncode}: {err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    return outs, time.time() - t0


def sharded_phase(seed, eng, art, cfg, enc, slot_batches, results, name,
                  smi):
    """Phase 5f, the sharded backend on the phase-3 100k index:
      (a) ``SearchEngine.sharded`` over eight shards on this card
          (``Mesh([cuda:0] * 8, ("shard",))``, the default Config) at B =
          1 / 16 / 64 (kernel 1, kernel 2 at U = 128, kernel 3 at U =
          256): each shard launches the batch's kernel once and kernel 4
          once a bucket; top-10 held to the one-card engine (ids except
          near-ties, scores and windows to 1e-3), ``bm25_search`` and
          ``dense_search`` too; p50 of both engines in turns, one
          ``torch.profiler`` trace a batch (busy time, idle share, device
          operations), the collectives a call;
      (b) a (dp = 2, shard = 4) mesh on the same card, and the int8 bank
          over eight shards, each held to the one-card engine with the
          same bank;
      (c) the scatter stage 1 (``use_pallas=False``) one-card and over
          eight shards at B = 16: keyed BM25 against the slot kernels, the
          same top-10;
      (d) ``ShardedQueryEncoder`` over the eight shards against one encode
          of the bi-encoder at full width (weights from ``seed``): unit
          embeddings to 5e-3;
      (e) two processes of the multihost CLI, four shards each on this
          card over gloo, flat and ``--hierarchical``: both print the
          one-card engine's ranking of the demo corpus; their warm merge
          times;
      (f) the serving CLI with ``--sharded`` on phase 5d's saved cut: a
          one-shard mesh on one card, /api/search answered;
      (g) with more than one card, (a) over distinct cards.
    Returns the launch counts of (a)."""
    from modern_search_engines_project_tpu_torch.parallel import multihost
    from modern_search_engines_project_tpu_torch.parallel.sharding import (
        Mesh,
        ShardedQueryEncoder,
    )

    t_phase = time.time()
    dev = eng.device
    want_bm25 = {"B=1": "bm25_slots", "B=16": "bm25_slots_udedup_sublane",
                 "B=64": "bm25_slots_udedup_i8"}
    mesh8 = Mesh(np.array([dev] * N_SHARDS, dtype=object), ("shard",))

    # (a) eight shards on one card ------------------------------------------
    t0 = time.time()
    eng8 = SearchEngine.sharded(art, enc, mesh8, cfg)
    torch.cuda.synchronize()
    s = eng8.didx
    log(f"sharded: {N_SHARDS} shards on {dev} built in "
        f"{time.time() - t0:.1f} s; d_loc {s.d_loc}, {len(s.buckets)} "
        f"buckets, posting_cap {s.posting_cap}, "
        f"{sum(sh.resident_bytes() for sh in s.shards) / 1e6:.1f} MB resident "
        f"(one card: {eng.didx.resident_bytes() / 1e6:.1f} MB)")
    launches = sharded_batches(eng8, eng, slot_batches, results,
                               f"{N_SHARDS} shards", N_SHARDS, want_bm25)
    for q in slot_batches["B=16"][:4]:
        same_scored(bm25_rows(eng8.bm25_search(q, top_k=100)),
                    bm25_rows(eng.bm25_search(q, top_k=100)), BM25_ATOL,
                    f"sharded bm25_search {q!r}")
        same_scored(dense_rows(eng8.dense_search(q, top_k=10)),
                    dense_rows(eng.dense_search(q, top_k=10)), E2E_ATOL,
                    f"sharded dense_search {q!r}")
    log("  bm25_search (top 100) and dense_search (top 10) on 4 queries == "
        "the one-card engine")
    for key, qs in slot_batches.items():
        eng8.times = StageTimes()
        p50 = timed_pair({"one card": eng, f"{N_SHARDS} shards": eng8}, qs)
        host = {k: v["mean_ms"] for k, v in eng8.times.report().items()}
        prof = {k: profile_call(lambda e=e: e.search_batch(qs, top_k=10))
                for k, e in (("one card", eng), (f"{N_SHARDS} shards", eng8))}
        for k, p in prof.items():
            if p is not None:
                p["idle_share_of_p50"] = 1.0 - p["device_busy_ms"] / p50[k]
                p.pop("top_device_ms")
        log(f"  search_batch {key}: p50 (ms) {json.dumps(p50)} on {name} "
            f"({smi}); {N_SHARDS}-shard host stage means (ms) {host}; "
            f"torch.profiler, one call each: {json.dumps(prof)}")

    # (b) the (dp, shard) mesh and the int8 bank -----------------------------
    t0 = time.time()
    mesh2 = Mesh(np.array([[dev] * 4] * 2, dtype=object), ("dp", "shard"))
    eng2 = SearchEngine.sharded(art, enc, mesh2, cfg)
    check(eng2.didx.rows[0][0] is eng2.didx.rows[1][0],
          "dp replicas on one card do not share their shard")
    for key in ("B=16", "B=64"):
        reset_launches()
        res = eng2.search_batch(slot_batches[key], top_k=10)
        c = read_launches()
        check_batch_launches(c, 8, len(eng2.didx.buckets), f"dp 2 x shard 4 {key}")
        for i, (g, w) in enumerate(zip(res, results[key])):
            same_top(g, w, f"dp 2 x shard 4 vs one card {key} q{i}")
    log(f"  dp 2 x shard 4 on one card (built in {time.time() - t0:.1f} s, "
        f"replicas share their shards): top-10 of B = 16, 64 == the one-card "
        f"engine; collectives a call {eng2._backend.last_collectives}")
    del eng2
    t0 = time.time()
    eng8_i8 = SearchEngine.sharded(art, enc, mesh8, cfg, bank_dtype="int8")
    one_i8 = SearchEngine(art, enc, cfg, bank_dtype="int8")
    for key in ("B=1", "B=16"):
        reset_launches()
        got = eng8_i8.search_batch(slot_batches[key], top_k=10)
        check(read_launches()["dense_stats"] == 0,
              "int8 bank: kernel 4 launched")
        for i, (g, w) in enumerate(zip(
                got, one_i8.search_batch(slot_batches[key], top_k=10))):
            same_top(g, w, f"int8 {N_SHARDS} shards vs one card {key} q{i}")
    log(f"  int8 bank, {N_SHARDS} shards vs one card ({time.time() - t0:.1f} "
        "s with both builds): top-10 of B = 1, 16 equal, kernel 4 never")
    del eng8_i8, one_i8

    # (c) the scatter stage 1 ------------------------------------------------
    t0 = time.time()
    qs = slot_batches["B=16"]
    tids, qtf, _ = eng.prepare_queries(qs)
    t = torch.as_tensor(tids, device=dev)
    q = torch.as_tensor(qtf, device=dev)
    errs = {}
    for i, sh in enumerate(s.shards):
        got = ops.bm25_score_batch(sh.indptr, sh.post_docs, sh.post_impact,
                                   t, q, n_docs_pad=s.d_loc,
                                   posting_cap=s.posting_cap)[:, : s.d_loc]
        want = bm25_score_slots(sh, t, q)[:, : s.d_loc]
        excess = ((got - want).abs() - WIDE_RTOL * want.abs()).max().item()
        check(excess <= BM25_ATOL and torch.equal(got < 0, want < 0),
              f"shard {i}: scatter vs kernel 1 keyed scores")
        errs[f"shard {i}"] = (got - want).abs().max().item()
    one_sc = SearchEngine(art, enc, cfg, use_pallas=False)
    d = one_sc.didx
    got = ops.bm25_score_batch(d.indptr, d.post_docs, d.post_impact, t, q,
                               n_docs_pad=d.n_docs_pad,
                               posting_cap=d.posting_cap)[:, : art.n_docs]
    want = to_artifact_order(bm25_score_slots(eng.didx, t, q),
                             eng.didx.doc_perm, art.n_docs)
    excess = ((got - want).abs() - WIDE_RTOL * want.abs()).max().item()
    check(excess <= BM25_ATOL and torch.equal(got < 0, want < 0),
          "one card: scatter vs kernel 1 keyed scores")
    errs["one card"] = (got - want).abs().max().item()
    eng8_sc = SearchEngine.sharded(art, enc, mesh8, cfg, use_pallas=False)
    for label, e in (("one card", one_sc), (f"{N_SHARDS} shards", eng8_sc)):
        reset_launches()
        res = e.search_batch(qs, top_k=10)
        c = read_launches()
        n_stats = 0 if e is one_sc else N_SHARDS * len(s.buckets)
        check(c == {k: n_stats if k == "dense_stats" else 0 for k in c},
              f"scatter {label}: launches {c}")
        for i, (g, w) in enumerate(zip(res, results["B=16"])):
            same_top(g, w, f"scatter {label} vs slots B=16 q{i}")
    p50 = timed_pair({"one card scatter": one_sc,
                      f"{N_SHARDS} shards scatter": eng8_sc, "one card": eng},
                     qs, reps=5)
    log(f"  scatter stage 1 at B = 16 ({time.time() - t0:.1f} s): keyed BM25 "
        f"vs kernel 1 max abs err {json.dumps(errs)}; top-10 == the slot path "
        f"one-card and over {N_SHARDS} shards; p50 (ms) {json.dumps(p50)}")
    del one_sc, eng8_sc

    # (d) the query encoder over the mesh ------------------------------------
    t0 = time.time()
    rng = np.random.default_rng(seed + 7)
    tree = init_reference_params(
        EncoderConfig(), lambda sh: rng.standard_normal(sh, dtype=np.float32))
    tenc = TorchEncoder(EncoderConfig(), params=tree)
    del tree
    senc = ShardedQueryEncoder(tenc, mesh8)
    check(list(senc.replicas) == [dev], "the encoder was copied on one card")
    errs = {}
    for key in ("B=1", "B=16", "B=64"):
        texts = [preprocess_query(x) for x in slot_batches[key]]
        got = senc(texts).cpu().numpy()
        want = tenc.encode_batch(texts)
        want = want / np.maximum(np.linalg.norm(want, axis=1, keepdims=True),
                                 1e-12)
        e = float(np.abs(got - want).max())
        cos = float((got * want).sum(1).min())
        check(e <= ENC_ATOL and cos >= ENC_COS,
              f"sharded encoder {key}: max |d| {e}, min cos {cos}")
        errs[key] = {"max_abs_err": e, "min_cos": cos}
    texts = [preprocess_query(x) for x in slot_batches["B=64"]]
    ms = {"one encode": cuda_ms(lambda: tenc.encode_batch_device(texts), 5),
          f"{N_SHARDS} parts": cuda_ms(lambda: senc(texts), 5)}
    log(f"  ShardedQueryEncoder (12L/768d, weights from --seed) over "
        f"{N_SHARDS} shards vs one encode: {json.dumps(errs)}; B = 64 wall "
        f"ms {json.dumps(ms)} on {name} ({time.time() - t0:.1f} s)")
    del senc, tenc

    # (e) two processes over gloo ---------------------------------------------
    dcfg = Config(**multihost.DEMO_CONFIG)
    denc = HashingEncoder(dim=dcfg.embedding_dim)
    demo = SearchEngine(IndexBuilder(denc, dcfg).build(
        multihost.demo_corpus(64)), denc, dcfg)
    want = [[(d.doc_id, round(d.similarity_score, 4)) for d in r]
            for r in demo.search_batch(multihost.QUERIES, top_k=5)]
    for hier in (False, True):
        outs, wall = multihost_run(hier)
        check(outs[0]["results"] == outs[1]["results"],
              f"multihost hierarchical={hier}: processes differ")
        check(outs[0]["backend"] == "gloo" and outs[0]["device"] == str(dev),
              f"multihost: {outs[0]['backend']} on {outs[0]['device']}")
        for i, (g, w) in enumerate(zip(outs[0]["results"], want)):
            check(len(g) > 0, "multihost: empty ranking")
            same_scored([tuple(x) for x in g], w, DEMO_ATOL,
                        f"multihost hierarchical={hier} q{i}")
        log(f"  multihost, 2 processes x 4 shards on {dev} over gloo, "
            f"hierarchical={hier}: both print the one-card ranking ({wall:.1f} "
            f"s wall); warm search_batch ms "
            f"{[o['rank_ms_per_batch'] for o in outs]}, of it host ms in the "
            f"cross-process collectives "
            f"{[o['collective_ms_per_batch'] for o in outs]} on {name} ({smi})")

    # (f) the serving CLI, --sharded ------------------------------------------
    idx_dir = os.path.join(ROOT, "build", "serve_index")
    check(os.path.isdir(idx_dir), "phase 5d's saved cut is missing")
    port = free_port()
    with open(os.path.join(ROOT, "build", "serve_sharded.log"), "wb") as logf:
        t0 = time.time()
        proc = subprocess.Popen(
            [sys.executable, "-m", "modern_search_engines_project_tpu_torch."
             "serving", "--index", idx_dir, "--host", "127.0.0.1", "--port",
             str(port), "--sharded"],
            stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT)
        try:
            deadline = time.time() + 300
            while True:
                check(proc.poll() is None and time.time() < deadline,
                      f"CLI --sharded: not healthy (rc {proc.poll()}), see "
                      "build/serve_sharded.log")
                try:
                    if http_json(port, "GET", "/api/health", timeout=5)[0] \
                            == 200:
                        break
                except OSError:
                    time.sleep(0.5)
            boot_s = time.time() - t0
            n_docs = 0
            for qq in slot_batches["B=16"][:4]:
                st, body = http_json(port, "POST", "/api/search",
                                     {"query": qq, "top_k": 10})
                check(st == 200, f"CLI --sharded {qq!r}: {st}")
                n_docs += len(body["documents"])
            check(n_docs > 0, "CLI --sharded: every result empty")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            check(rc in (0, -signal.SIGTERM), f"CLI --sharded: exit code {rc}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    with open(os.path.join(ROOT, "build", "serve_sharded.log")) as f:
        mesh_line = [ln.strip() for ln in f if "sharded engine" in ln]
    check(mesh_line and "(1,)" in mesh_line[0],
          f"CLI --sharded: the log names no one-shard mesh: {mesh_line}")
    log(f"  CLI --sharded on the {SERVE_CUT_DOCS}-doc cut: healthy "
        f"{boot_s:.1f} s after start (warmup included), 4 queries answered "
        f"({n_docs} rows), exit {rc}; its log: {mesh_line[0]!r}")

    # (g) several cards --------------------------------------------------------
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        n = min(N_SHARDS, n_cards)
        cards = Mesh(np.array([torch.device("cuda", i) for i in range(n)],
                              dtype=object), ("shard",))
        eng_c = SearchEngine.sharded(art, enc, cards, cfg)
        sharded_batches(eng_c, eng, slot_batches, results,
                        f"{n} shards on {n} cards", n, want_bm25)
        p50 = timed_pair({"one card": eng, f"{n} cards": eng_c},
                         slot_batches["B=64"])
        log(f"  {n} cards, B = 64: p50 (ms) {json.dumps(p50)}")
        del eng_c
    else:
        log("  one card visible: the cross-card copies of the merge went "
            "unmeasured")
    log(f"  sharded phase: {time.time() - t_phase:.1f} s")
    return launches



# ---- phase 5g: the last modules --------------------------------------------

# (a): the dp x tp step against one card in f32 (the row products' sums in
# f32 are the only change of summation order): loss to 1e-5, every
# gradient leaf and every updated leaf to 1e-4 of its largest magnitude.
TP_LOSS_ATOL, TP_LEAF_TOL = 1e-5, 1e-4
TP_MESH = (2, 2)  # dp x tp
# (e): the real-text pass: pages of installed packages' documentation,
# served on this many loopback hosts
REAL_DOCS, REAL_HOSTS = 2_000, 8
REAL_DIR = os.path.join(ROOT, "build", "real_smoke")


def tp_mesh(devices):
    """A (dp, tp) = TP_MESH mesh over ``devices`` (4 entries)."""
    return Mesh(np.array(devices, dtype=object).reshape(*TP_MESH),
                ("dp", "tp"))


def shard_grads(sharded, grads):
    """Give ``sharded``'s master shards the one-card trainer's gradients
    (by ``BiEncoder`` state-dict name), split as its layout splits them."""
    tp = sharded.model.tp
    for n, ps in sharded.model.shards.items():
        ax = sharded.model.axis[n]
        parts = [grads[n]] if ax is None else grads[n].chunk(tp, dim=ax)
        for p, g in zip(ps, parts):
            p.grad = g.to(p.device, copy=True).contiguous()


def tp_against_one_card(tree, devices, triples):
    """(a), first part: one f32 step at B = 8, L = 32 (``infonce_hn``) of
    the dp x tp trainer on ``devices`` and of the one-card trainer, same
    tree and batch: the losses, every gradient leaf, then every leaf after
    an update at the schedule's full rate.  Both optimizers step from the
    one-card gradients (the masters receive them split by the layout), so
    near-zero gradients, whose Adam steps flip sign with rounding, do not
    mask a fault of the sharded update; the leaves after each trainer's
    own gradients are printed.  Returns the errors."""
    cfg = dataclasses.replace(EncoderConfig(), dtype="float32")
    tcfg = TrainConfig(loss="infonce_hn", max_len=32, batch_size=8)
    one = Trainer(cfg, tcfg).init(10, params=tree)
    tp = Trainer(cfg, tcfg, mesh=tp_mesh(devices)).init(10, params=tree)
    batch = one.encode_pairs(triples)
    out, losses = {}, []
    for tr in (one, tp):
        loss = tr.loss(tr.upload_batch(batch))
        loss.backward()
        losses.append(float(loss.detach()))
    check(abs(losses[0] - losses[1]) <= TP_LOSS_ATOL,
          f"dp x tp vs one card: loss {losses[1]} vs {losses[0]}")
    g_one, g_tp = tree_leaves(one.grads()), tree_leaves(tp.grads())
    worst, leaf = worst_leaf(g_tp, g_one)
    check(worst <= TP_LEAF_TOL, f"dp x tp vs one card: gradient {leaf} off "
          f"by {worst} of its largest magnitude")
    out.update(loss_one=losses[0], loss_tp=losses[1],
               loss_abs_err=abs(losses[0] - losses[1]),
               grad_worst_rel_err=worst, grad_worst_leaf=leaf)
    own = [p.grad.clone() for p in tp.model.parameters()]
    grads = {n: p.grad for n, p in one.model.named_parameters()}
    shard_grads(tp, grads)
    for tr in (one, tp):
        tr.step_count = 1  # the schedule's full rate (step 0 has rate 0)
        tr.update()
    p_one, p_tp = tree_leaves(one.params), tree_leaves(tp.params)
    worst, leaf = worst_leaf(p_tp, p_one)
    check(worst <= TP_LEAF_TOL, f"dp x tp vs one card: updated {leaf} off by "
          f"{worst} of its largest magnitude")
    out.update(updated_worst_rel_err=worst, updated_worst_leaf=leaf)
    # the same update from each trainer's own gradients, printed only
    tp2 = Trainer(cfg, tcfg, mesh=tp_mesh(devices)).init(10, params=tree)
    for p, g in zip(tp2.model.parameters(), own):
        p.grad = g
    tp2.step_count = 1
    tp2.update()
    out["own_grads_updated_worst_rel_err"], _ = worst_leaf(
        tree_leaves(tp2.params), p_one)
    return out


def timed_tp(tree, devices, pairs, name, smi, what):
    """(a), second part: stage A's shapes (InfoNCE, B = 256, L = 128) on
    the dp x tp mesh over ``devices`` and on one card in the same run:
    warm step ms, tokens/s, device operations, busy and idle share of one
    traced step (``time_train_steps``), peak memory."""
    tcfg = TrainConfig(loss="infonce", batch_size=STAGE_A_B, max_len=TRAIN_L)
    rows = {}
    for label, mesh in (("one card", None), (what, tp_mesh(devices))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(EncoderConfig(), tcfg, mesh=mesh)
        tr.init(10 * TIMED_STEPS, params=tree)
        batch = tr.encode_pairs([(q, p, 1.0) for q, p in pairs[:STAGE_A_B]])
        tr.step(batch)  # warm
        time_train_steps(tr, batch, f"stage A infonce, {label}", name, smi)
        rows[label] = torch.cuda.max_memory_allocated() / 2**30
        del tr
    log(f"  peak device memory (GiB, torch.cuda.max_memory_allocated): "
        f"{json.dumps(rows)}")


def tp_phase(seed, words, dfs, name, smi):
    """Phase 5g (a), the dp x tp training step at the flagship's width
    (12 layers, 768 wide; warm-started from runs/encoder-real where it is
    present, else weights drawn from ``seed``) on ``Mesh([cuda:0] * 4)
    .reshape(2, 2), ("dp", "tp"))``: one f32 step against the one-card
    trainer (``tp_against_one_card``), then stage A's shapes timed beside
    one card (``timed_tp``); with four or more cards visible, the mesh
    over distinct cards as well."""
    t0 = time.time()
    enc_cfg = EncoderConfig()
    real = os.path.join(ROOT, "runs", "encoder-real")
    if os.path.exists(os.path.join(real, "params.msgpack")):
        tree, _ = load_encoder(real)
        start = "runs/encoder-real"
    else:
        rng = np.random.default_rng(seed + 8)
        tree = init_reference_params(
            enc_cfg, lambda s: rng.standard_normal(s, dtype=np.float32))
        start = f"weights drawn from seed {seed + 8}"
    windows = SyntheticWindows(seed + 8, words, dfs, STAGE_A_B + 16)
    df_of = dict(zip(words, dfs))
    pairs = [(" ".join(sorted(set(w[:-1].replace(". ", " ").split()),
                              key=df_of.get)[:3]), w)
             for w in (windows[i] for i in range(STAGE_A_B + 16))]
    small = [(q[:60], p[:300], pairs[i + 8][1][:300])
             for i, (q, p) in enumerate(pairs[:8])]
    layouts = [("dp 2 x tp 2 on one card", [resolve_device(None)] * 4)]
    if torch.cuda.device_count() >= 4:
        layouts.append(("dp 2 x tp 2 on four cards",
                        [torch.device("cuda", i) for i in range(4)]))
    else:
        log(f"  one card visible ({torch.cuda.device_count()}): the mesh over "
            f"distinct cards is not run")
    n_cards = torch.cuda.device_count()
    run = subprocess.run(
        [sys.executable, "-m",
         "modern_search_engines_project_tpu_torch.models.train_cli", "--dp",
         "2", "--tp", "2", "--layers", "1", "--dim", "64", "--synthetic",
         "16", "--batch-size", "8", "--out",
         os.path.join(ROOT, "build", "tp_cli_encoder")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if n_cards < 4:
        check(run.returncode != 0 and f"needs 4 visible CUDA devices, "
              f"{n_cards} visible" in run.stderr,
              f"train_cli --dp 2 --tp 2 on {n_cards} card(s): exit "
              f"{run.returncode}, {run.stderr[-400:]}")
    else:
        check(run.returncode == 0, f"train_cli --dp 2 --tp 2: "
              f"{run.stderr[-400:]}")
    log(f"  train_cli --dp 2 --tp 2 with {n_cards} card(s) visible: exit "
        f"{run.returncode}, {run.stderr.strip().splitlines()[-1][-120:]}")
    for what, devices in layouts:
        errs = tp_against_one_card(tree, devices, small)
        log(f"  dp x tp step ({what}; {start}) against one card, f32, "
            f"B = 8, L = 32, infonce_hn (loss {TP_LOSS_ATOL}, leaves "
            f"{TP_LEAF_TOL}): {json.dumps(errs)}")
        timed_tp(tree, devices, pairs, name, smi, what)
    log(f"phase 5g (a) {time.time() - t0:.1f} s")


def entry_phase(name, smi):
    """Phase 5g (b): ``entry()``'s forward (12L/768d, B = 8, L = 512) on the
    card against the port on the CPU (ENC_ATOL, as phase 5b), then
    ``dryrun_multichip(8)`` on the card (eight entries, the card repeated).
    Returns the dry run's launch counts."""
    t0 = time.time()
    fwd, args = entry()
    got = fwd(*args).float().cpu()
    fwd_c, args_c = entry(device="cpu")
    want = fwd_c(*args_c).float()
    err = float((got - want).abs().max())
    check(got.shape == (8, 768) and err <= ENC_ATOL,
          f"entry(): card vs cpu {err} (shape {tuple(got.shape)})")
    ms = cuda_ms(lambda: fwd(*args), 5)
    prof = profile_call(lambda: fwd(*args))
    busy = ("not measured" if prof is None else
            f"{prof['device_busy_ms']:.3f} ms busy, "
            f"{prof['device_events']} device operations")
    log(f"  entry(): the flagship forward at (8, 512) on the card == the cpu "
        f"port (max abs err {err:.2e} <= {ENC_ATOL}); {ms:.3f} ms a forward "
        f"(CUDA events, enqueue included), {busy}, bound "
        f"{encoder_bound(EncoderConfig(), 8, 512)[0]:.3f} ms on {name} "
        f"({smi})")
    reset_launches()
    res = dryrun_multichip(8)
    counts = read_launches()
    check(counts["bm25_slots"] > 0 and counts["dense_stats"] > 0,
          f"dryrun_multichip(8): launches {counts}")
    log(f"  dryrun_multichip(8) on {res['devices']}: loss {res['losses']}, "
        f"results {len(res['shard'])} / "
        f"{[len(r) for r in res['dp_shard']]} / "
        f"{[len(r) for r in res['encoder']]}; launches {counts} "
        f"({time.time() - t0:.1f} s)")
    return {"8 entries": counts}


def dedup_batches(eng, slot_batches):
    """Phase 5g (c) on phase 3's slot batches at B = 16 and 64: the device
    dedup equal to the host's bit for bit (pads -2 and 0 past the distinct
    count), with no host sync; the batch's U-dedup kernel (2 at B = 16,
    3 at B = 64, as ``udedup_plan`` picks) fed from it gives the host
    route's keyed scores bit for bit; a batch over a budget below its
    distinct count drops ids as the function does on the CPU.  Returns
    the launches of the device route's kernel calls."""
    launches = {}
    for key in ("B=16", "B=64"):
        tids, qtf, _ = eng.prepare_queries(slot_batches[key])
        uids_h, w_h = dedup_query_terms(tids, qtf)
        n = int((uids_h >= 0).sum())
        u_pad = uids_h.size
        t = torch.as_tensor(tids, device=eng.device)
        q = torch.as_tensor(qtf, device=eng.device)
        uids_d, w_d = check_sync_free(
            lambda: dedup_query_terms_device(t, q, u_pad),
            f"dedup_query_terms_device {key} (U = {u_pad})")
        check(np.array_equal(uids_d.cpu().numpy(), uids_h)
              and np.array_equal(w_d.cpu().numpy(), w_h),
              f"device dedup {key}: differs from the host's")
        check((uids_d[n:] == -2).all().item() and (w_d[:, n:] == 0).all().item(),
              f"device dedup {key}: pads past U = {n}")
        variant = udedup_plan(u_pad, len(tids))
        want = bm25_score_slots_udedup(
            eng.didx, torch.as_tensor(uids_h, device=eng.device),
            torch.as_tensor(w_h, device=eng.device), variant)
        reset_launches()
        got = bm25_score_slots_udedup(eng.didx, uids_d, w_d, variant)
        launches[key] = read_launches()
        check(torch.equal(got, want), f"device dedup {key}: kernel "
              f"{variant} scores differ from the host route's")
        small = max(8, n // 2)
        cut = dedup_query_terms_device(t, q, small)
        ref = dedup_query_terms_device(t.cpu(), q.cpu(), small)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(cut, ref)),
              f"device dedup {key}: the drop beyond u_pad = {small}")
        log(f"  device dedup {key}: {n} distinct of U = {u_pad}, equal to the "
            f"host's; kernel {variant} fed from it == the host route bit for "
            f"bit, launches {launches[key]}; u_pad = {small} drops as on the "
            f"cpu")
    return launches


def load_test_cli():
    """Phase 5g (d), second part: the load test's CLI in native engine mode
    as a subprocess (its own 4,000-doc engine on the card, the data
    plane, 2,000 requests over 64 connections)."""
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m",
         "modern_search_engines_project_tpu_torch.eval.load_test",
         "--native", "engine", "--docs", "4000", "--requests", "2000",
         "--port", str(free_port())],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    check(out.returncode == 0, f"load_test --native engine: "
          f"{out.stdout[-400:]} {out.stderr[-800:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    check(rec["client"]["errors"] == 0 and rec["client"]["requests"] == 2000
          and rec["device"].startswith("cuda"), f"load_test: {rec}")
    log(f"  load_test --native engine (a subprocess, "
        f"{time.time() - t0:.1f} s): {json.dumps(rec)}")


def serve_site(site_dir):
    """``http.server`` over ``site_dir`` in a thread, on every loopback
    address; returns (server, port)."""
    import functools
    import http.server

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *a):
            pass

    class Server(http.server.ThreadingHTTPServer):
        daemon_threads = True

    httpd = Server(("0.0.0.0", 0),
                   functools.partial(Quiet, directory=site_dir))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def summary_query(site_dir, url):
    """A module page's docstring summary line (its first paragraph's first
    sentence, at most 12 words) read from the site's file; "" for the
    index and archive pages."""
    import html as html_mod
    import re
    import urllib.parse

    rel = urllib.parse.urlsplit(url).path.lstrip("/")
    if not rel.endswith(".html") or rel.startswith("archive/"):
        return ""  # the root index and the archive pages hold no docstring
    with open(os.path.join(site_dir, rel), encoding="utf-8") as f:
        m = re.search(r"<p>(.*?)</p>", f.read(), re.S)
    if not m:
        return ""
    text = html_mod.unescape(m.group(1)).split(". ")[0]
    return " ".join(text.split()[:12])


def real_text_phase(seed, cfg, name, smi):
    """Phase 5g (e), the real-text pass (``tools/real_run.py``'s recipe on
    the port): ``tools/make_real_corpus.build_site`` writes REAL_DOCS pages
    of the installed packages' docstrings on REAL_HOSTS loopback hosts
    (its robots.txt: ``Crawl-delay: 0``, ``/private`` disallowed),
    ``http.server`` serves them, the port's crawler fetches them over its
    asyncio transport with the stdlib parser into a ``CrawlStore`` (no
    ``/private`` page stored), ``merge_crawls``, ``BuildPipeline`` with the
    bi-encoder on the card (runs/encoder-real where present, else weights
    from ``seed``), ``search_batch`` at B = 1 / 16 / 64 on summary-line
    queries (launches as in phase 5, top-10 against the numpy oracle), and
    ``POST /api/batch_search_file`` on the control plane; recall@10 and
    NDCG@10 against the oracle printed, not gated.  Returns the
    launches."""
    import importlib.util

    t_phase = time.time()
    shutil.rmtree(REAL_DIR, ignore_errors=True)
    os.makedirs(REAL_DIR)
    spec = importlib.util.spec_from_file_location(
        "make_real_corpus", os.path.join(ROOT, "tools", "make_real_corpus.py"))
    mrc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mrc)
    site_dir = os.path.join(REAL_DIR, "site")
    httpd, port = serve_site(site_dir)
    bases = [f"http://127.0.0.{i}:{port}" for i in range(1, REAL_HOSTS + 1)]
    try:
        t0 = time.time()
        man = mrc.build_site(site_dir, max_docs=REAL_DOCS, base_urls=bases)
        log(f"real text: {man['n_pages']} pages ({man['n_private_pages']} "
            f"under /private, {man['prose_bytes'] / 1e6:.1f} MB) of "
            f"{len(man['packages'])} packages on {REAL_HOSTS} loopback hosts, "
            f"written in {time.time() - t0:.1f} s")
        store = CrawlStore(os.path.join(REAL_DIR, "crawl.sqlite"))
        crawler = Crawler(store, fetcher=Fetcher(AsyncioTransport(timeout=5.0)),
                          max_batch=100, content_filter=False,
                          expand_threshold=-1.0)
        t0 = time.time()
        asyncio.run(crawler.run([bases[0] + "/"]))
        t_crawl = time.time() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
    docs = list(store.iter_documents(min_score=-1.0))
    private = [d.url for d in docs if "/private/" in d.url]
    check(not private, f"crawl stored robots-disallowed pages: {private[:3]}")
    check(len(docs) >= 0.9 * (man["n_pages"] - man["n_private_pages"]),
          f"crawl stored {len(docs)} of {man['n_pages']} pages")
    log(f"  crawl (asyncio transport, stdlib parser): {len(docs)} pages in "
        f"{t_crawl:.1f} s ({len(docs) / t_crawl:.1f} pages/s), {crawler.rounds} "
        f"rounds, 0 under /private, {len(crawler.frontier)} left in the "
        f"frontier")
    merged = CrawlStore(os.path.join(REAL_DIR, "merged.sqlite"))
    rep = merge_crawls(merged, store)
    check(rep.merged > 0 and rep.incoming == len(docs), f"merge: {rep}")
    log(f"  merge_crawls: {dataclasses.asdict(rep)}")
    docs = [Document(i + 1, d.url, d.title, d.text)
            for i, d in enumerate(merged.iter_documents(min_score=-1.0))]
    real = os.path.join(ROOT, "runs", "encoder-real")
    if os.path.exists(os.path.join(real, "params.msgpack")):
        enc = TorchEncoder.from_checkpoint(real, batch_size=64, max_len=128)
        start = "runs/encoder-real"
    else:
        enc = TorchEncoder(EncoderConfig(), batch_size=64, max_len=128,
                           generator=torch.Generator().manual_seed(seed + 9))
        start = f"weights drawn from seed {seed + 9}"
    rcfg = cfg.replace(embedding_dim=enc.cfg.dim)
    t0 = time.time()
    art = BuildPipeline(enc, os.path.join(REAL_DIR, "index"), rcfg,
                        shard_size=512).build(docs)
    t_build = time.time() - t0
    check(art.n_docs == len(docs) and np.isfinite(art.chunk_emb).all(),
          f"real build: {art.n_docs} docs")
    log(f"  BuildPipeline ({start}, on the card): {art.n_docs} docs, "
        f"{art.n_chunks} windows, {art.n_terms} terms in {t_build:.1f} s "
        f"({art.n_docs / t_build:.1f} docs/s, {art.n_chunks / t_build:.1f} "
        f"windows/s) on {name} ({smi})")
    eng = SearchEngine(art, enc, rcfg)
    pool = []
    for d in docs:
        q = summary_query(site_dir, d.url)
        if len(q.split()) >= 3 and q not in pool:
            pool.append(q)
        if len(pool) == 64:
            break
    check(len(pool) == 64, f"{len(pool)} summary-line queries")
    batches = {"B=1": pool[:1], "B=16": pool[:16], "B=64": pool}
    n_buckets = len(eng.didx.buckets)
    launches, results = {}, {}
    for key, qs in batches.items():
        eng.search_batch(qs, top_k=10)  # warm
        reset_launches()
        results[key] = eng.search_batch(qs, top_k=10)
        launches[key] = read_launches()
        check_batch_launches(launches[key], 1, n_buckets, f"real text {key}")
    _, _, processed = eng.prepare_queries(pool)
    all_q = eng.encode_queries(processed).cpu().numpy()  # the engine's own
    same_as_oracle(art, None, rcfg, results["B=16"], pool[:3],
                   "real text B=16", qvecs=all_q)
    p50 = {}
    for key, qs in batches.items():
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.search_batch(qs, top_k=10)
            ts.append((time.perf_counter() - t0) * 1e3)
        p50[key] = float(np.median(ts))
    log(f"  search_batch on the real-text index: launches {launches}; p50 ms "
        f"{json.dumps(p50)}; top-10 == numpy oracle on 3 queries")
    # recall@10 / NDCG@10 against the oracle, for information
    from modern_search_engines_project_tpu_torch.eval.metrics import (
        ndcg_at_k,
        recall_at_k,
    )

    bf = dataclasses.replace(
        art, chunk_emb=torch.from_numpy(art.chunk_emb).bfloat16().float()
        .numpy())
    rec, ndcg = [], []
    for i, (q, got) in enumerate(zip(pool, results["B=64"])):
        o = hybrid_search_numpy(
            bf, preprocess_query(q),
            torch.from_numpy(all_q[i]).bfloat16().float().numpy(),
            rcfg.top_k_retrieval, 10, rcfg.smoothing,
            diversification=rcfg.diversification)
        o_urls = [d.url for d in o]
        e_urls = [d.url for d in got]
        gains = {u: 10 - j for j, u in enumerate(o_urls)}
        rec.append(recall_at_k(e_urls, set(o_urls), 10))
        ndcg.append(ndcg_at_k(e_urls, gains, 10))
    qpath = os.path.join(REAL_DIR, "queries.txt")
    with open(qpath, "w", encoding="utf-8") as f:
        f.writelines(f"{i + 1}\t{q}\n" for i, q in enumerate(pool[:16]))
    svc = SearchService(eng, queries_path=qpath,
                        results_path=os.path.join(REAL_DIR, "results.txt"))
    srv = ServerThread(svc.build_app()).start()
    try:
        t0 = time.perf_counter()
        st, body = http_json(srv.port, "POST", "/api/batch_search_file", {})
        t_http = time.perf_counter() - t0
    finally:
        srv.stop()
    check(st == 200 and body["total_queries"] == 16
          and body["total_results"] > 0, f"batch_search_file: {st} {body}")
    with open(os.path.join(REAL_DIR, "results.txt"), encoding="utf-8") as f:
        lines = f.read().splitlines()
    check(len(lines) == body["total_results"], "batch_search_file: the file")
    log(f"  POST /api/batch_search_file: {body['total_queries']} queries, "
        f"{body['total_results']} rows in {t_http * 1e3:.1f} ms; against the "
        f"oracle over 64 queries (not gated; not comparable with "
        f"docs/REAL_EVAL.md): recall@10 {np.mean(rec):.4f}, NDCG@10 "
        f"{np.mean(ndcg):.4f}")
    log(f"phase 5g (e) {time.time() - t_phase:.1f} s")
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

    # --- stage 3 and the assistant -----------------------------------------
    launches["stage 3"], q3, rows3 = stage3_phase(
        args.seed, art, words, dfs, cfg, eng, slot_batches, name, smi)
    decoder_phase(args.seed, words, q3, [r.window_text for r in rows3[:10]],
                  name, smi)

    # --- phase 5d: the serving surface ------------------------------------
    launches["serving"] = serving_phase(args.seed, eng, art, words, dfs, cfg,
                                        enc, slot_batches, name, smi)

    # --- phase 5e: training, checkpoints and the sharded build --------------
    launches["training"] = training_phase(args.seed, words, dfs, cfg, name,
                                          smi)

    # --- phase 5f: the sharded backend ---------------------------------------
    launches["sharded"] = sharded_phase(args.seed, eng, art, cfg, enc,
                                        slot_batches, results["slots"], name,
                                        smi)

    # --- phase 5g: the last modules ------------------------------------------
    t_5g = time.time()
    log("phase 5g: the dp x tp step, entry(), the device dedup, the load "
        "test's CLI, the real-text pass")
    tp_phase(args.seed, words, dfs, name, smi)
    launches["dry run"] = entry_phase(name, smi)
    launches["device dedup"] = dedup_batches(eng, slot_batches)
    load_test_cli()
    launches["real text"] = real_text_phase(args.seed, cfg, name, smi)
    log(f"phase 5g {time.time() - t_5g:.1f} s")

    # --- phase 6: small phases ----------------------------------------------
    check_empty_index(cfg, enc)
    launches["device dedup"].update(check_wide_batches(args.seed, eng.device))
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
