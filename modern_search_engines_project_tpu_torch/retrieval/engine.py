"""SearchEngine: host orchestration around the torch hybrid query path.

Counterpart of the reference package's ``retrieval/engine.py`` on its
kernel path: query preprocessing and term lookup on the host, then BM25
through one of the slot kernels (``bm25_layout="slots"``, the default) or
the blocked kernels (``bm25_layout="blocked"``, and every index without
chunk buckets), the bucketed dense tail with the stats kernel (or, without
buckets, the packed-bank tail), and host-side dedup and domain
diversification over the (at most) ``top_k_retrieval`` candidates (one
native call a batch, ``native/finish.cpp``), result formatting, and the
optional stage 3 (a cross-encoder rescoring each query's final rows).
``bm25_search`` and ``dense_search`` run one stage alone.
``use_pallas=False`` takes the reference's scatter path (CSR BM25 and the
packed bank, no kernel); ``SearchEngine.sharded`` ranks over an index
sharded on a mesh (``parallel/sharding.py``).

Runs on the card unless the caller passes ``device="cpu"``, where every
kernel wrapper takes its plain PyTorch version.

Two threads may call one engine at once (the C++ data plane keeps two
batches in flight): the index is read-only, every call allocates its own
tensors, the finishing pass keeps no state between calls (and releases
the interpreter lock), the stage timer and the kernels' launch counters
take locks, and both threads enqueue on the device's current stream, so
memory the caching allocator hands from one call to the other is
stream-ordered.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np
import torch

from modern_search_engines_project_tpu_torch.config import Config, resolve_approx
from modern_search_engines_project_tpu_torch.index.builder import IndexArtifacts
from modern_search_engines_project_tpu_torch.native.native_finish import Finisher
from modern_search_engines_project_tpu_torch.retrieval import ops
from modern_search_engines_project_tpu_torch.retrieval.bm25_blocked import (
    blocked_udedup_gate,
)
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    dedup_query_terms,
    u_pad_for,
    udedup_plan,
)
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    DeviceIndex,
    upload,
)
from modern_search_engines_project_tpu_torch.retrieval.numpy_ref import (
    preprocess_query,
)
from modern_search_engines_project_tpu_torch.retrieval.rerank import (
    RankedDoc,
    factorize,
)
from modern_search_engines_project_tpu_torch.text.analyzer import Analyzer
from modern_search_engines_project_tpu_torch.utils.timing import (
    StageTimes,
    stage_timer,
)


class SearchEngine:
    def __init__(
        self,
        artifacts: IndexArtifacts,
        encoder,
        config: Optional[Config] = None,
        bank_dtype=None,
        analyzer: Optional[Analyzer] = None,
        device=None,
        cross_encoder=None,
        use_pallas: Optional[bool] = None,
    ):
        """``device``: "cuda" (default) or "cpu"; with no card and no
        ``device="cpu"`` this raises.  ``bank_dtype`` defaults to bf16 on
        the card and f32 on the CPU; "int8" (or ``torch.int8``) serves
        per-row int8 bucket banks, which stay off kernel 4 (an s32 library
        product and the streaming top-2).  ``cross_encoder``: the optional stage
        3, anything with ``rescore(query, texts) -> float32 [n]``
        (``models.cross_encoder.CrossEncoderReranker``).  ``use_pallas``:
        None or True ranks through the kernels (their plain versions on
        the CPU); False takes the reference's scatter path (CSR BM25 and
        the packed bank, ``ops.hybrid_rank``, in artifact doc order),
        which launches no kernel."""
        self.art = artifacts
        self.cfg = config or artifacts.config
        self.encoder = encoder
        self.analyzer = analyzer or Analyzer()
        self.use_pallas = use_pallas is not False
        self.didx = DeviceIndex.from_artifacts(
            artifacts, self.cfg, bank_dtype=bank_dtype, device=device,
            bm25_layout=self.cfg.bm25_layout,
            packed_device=not self.use_pallas,
        )
        self.device = self.didx.device
        self.k_ret = min(self.cfg.top_k_retrieval, self.didx.n_docs_pad)
        self._approx = resolve_approx(self.cfg, self.didx.n_docs_pad)
        self.times = StageTimes()
        self.cross_encoder = cross_encoder
        # the kernel paths rank in the bucketed (permuted) doc order; an
        # index without buckets and the scatter path keep the artifact
        # order (no permutation)
        self._result_perm = self.didx.doc_perm if self.use_pallas else None
        self._init_finisher()

    def _init_finisher(self) -> None:
        """The host finishing pass (dedup by query-stripped url, domain
        diversification) over per-doc integer codes, built here, at set-up,
        and not by the first request."""
        self._finisher = Finisher(
            self._result_perm,
            factorize(self.art.domains),
            factorize([u.split("?", 1)[0] for u in self.art.urls]),
            self.art.doc_chunk_start,
            n_docs_real=len(self.art.doc_ids),
            n_wins=len(self.art.window_texts),
        )

    @classmethod
    def sharded(
        cls,
        artifacts: IndexArtifacts,
        encoder,
        mesh,
        config: Optional[Config] = None,
        bank_dtype=None,
        analyzer: Optional[Analyzer] = None,
        use_pallas: Optional[bool] = None,
    ) -> "SearchEngine":
        """The engine over an index sharded on ``mesh`` (a
        ``parallel.sharding.Mesh``): per-shard ranking, one fused candidate
        merge, the pool extrema and the per-candidate combine across
        shards (``parallel.sharding.ShardedEngineBackend``).  Same API as
        the one-device engine; ``bank_dtype`` defaults to bf16 on the card
        and f32 on the CPU ("int8" allowed); ``use_pallas=False`` takes the
        scatter stage 1.  A ``TorchEncoder`` encodes queries split over
        the mesh (``ShardedQueryEncoder``)."""
        from modern_search_engines_project_tpu_torch.models.encoder import (
            TorchEncoder,
        )
        from modern_search_engines_project_tpu_torch.parallel.sharding import (
            ShardedEngineBackend,
            ShardedQueryEncoder,
        )

        self = cls.__new__(cls)
        self.art = artifacts
        self.cfg = config or artifacts.config
        self.encoder = encoder
        self.analyzer = analyzer or Analyzer()
        backend = ShardedEngineBackend(
            artifacts, mesh, self.cfg, bank_dtype=bank_dtype,
            use_pallas=use_pallas,
        )
        self.didx = backend.sidx
        self.device = backend.device
        self.k_ret = backend.k_ret
        self.use_pallas = backend.use_pallas
        self.times = StageTimes()
        self.cross_encoder = None
        # shard docs are bucket-permuted; results map back on the host
        self._result_perm = backend.doc_perm
        self._backend = backend
        self._device_rank = backend.rank
        if isinstance(encoder, TorchEncoder):
            self._sharded_enc = ShardedQueryEncoder(encoder, mesh)
        self._init_finisher()
        return self

    # --- host-side query prep ----------------------------------------------

    def prepare_queries(self, queries: Sequence[str], augment: bool = True):
        """queries -> (term_ids [B, T], qtf [B, T], processed texts).

        Unique terms with query-term-frequency weights; the term axis is
        bucketed to 4/8/.../max_query_terms by the longest query."""
        T = self.cfg.max_query_terms
        B = len(queries)
        term_ids = np.full((B, T), -1, np.int32)
        qtf = np.zeros((B, T), np.float32)
        processed = []
        max_slots = 0
        for i, q in enumerate(queries):
            pq = preprocess_query(q) if augment else q
            processed.append(pq)
            counts = Counter(self.analyzer.tokens(pq))
            slot = 0
            for term, tf in counts.items():
                tid = self.art.vocab.get(term)
                if tid < 0:
                    continue
                if slot >= T:
                    break
                term_ids[i, slot] = tid
                qtf[i, slot] = float(tf)
                slot += 1
            max_slots = max(max_slots, slot)
        t_eff = 4
        while t_eff < max_slots:
            t_eff *= 2
        t_eff = min(t_eff, T)
        return term_ids[:, :t_eff], qtf[:, :t_eff], processed

    def encode_queries(self, processed: Sequence[str]):
        """Unit-norm query embeddings [B, dim].

        An encoder with ``encode_batch_device`` (``TorchEncoder``) gives a
        tensor on its device, normalised there with no host sync: the
        ranking dispatch queues behind the encode on the same stream, so
        the batch pays one host round trip, when the results come back.
        Host encoders give numpy, normalised on the host.  A sharded
        engine with a ``TorchEncoder`` splits the batch over its mesh."""
        senc = getattr(self, "_sharded_enc", None)
        if senc is not None:
            return senc(list(processed))
        enc_dev = getattr(self.encoder, "encode_batch_device", None)
        if enc_dev is not None:
            q = enc_dev(list(processed)).float()
            return q / torch.clamp(
                torch.linalg.vector_norm(q, dim=1, keepdim=True), min=1e-12
            )
        q = np.asarray(self.encoder.encode_batch(list(processed)), np.float32)
        norms = np.linalg.norm(q, axis=1, keepdims=True)
        return q / np.maximum(norms, 1e-12)

    # --- device calls -------------------------------------------------------

    def _device_rank(self, term_ids, qtf, qvec):
        """One batch through the resident layout's kernels, dispatched as
        the reference engine dispatches; returns device tensors (doc,
        fused, bm25_norm, win, valid), each [B, k_ret]."""
        d = self.didx
        dev = self.device
        q = torch.as_tensor(qvec, dtype=torch.float32, device=dev)
        kw = dict(k_ret=self.k_ret, smoothing=self.cfg.smoothing)
        tids_np = np.asarray(term_ids)
        B, T = tids_np.shape

        def up(a, dtype):  # does not wait for the query encode
            return upload(np.asarray(a, dtype), dev)

        def dense_args():
            return up(tids_np, np.int32), up(qtf, np.float32)

        if not self.use_pallas:  # the reference's scatter path
            return ops.hybrid_rank(
                d.indptr, d.post_docs, d.post_impact, d.chunk_emb,
                d.chunk_doc, d.doc_chunk_start, d.doc_n_chunks,
                *dense_args(), q, n_docs_pad=d.n_docs_pad,
                posting_cap=d.posting_cap, **kw,
            )
        if not d.buckets:  # no chunk buckets: blocked + packed-bank tail
            return ops.hybrid_rank_blocked(d, *dense_args(), q, **kw)
        kw["approx"] = self._approx
        plan = None
        if self.cfg.bm25_udedup:
            u_pad = u_pad_for(int(np.unique(tids_np[tids_np >= 0]).size))
            if d.bm25_layout == "slots":
                plan = udedup_plan(u_pad, B)
                if self.cfg.bm25_udedup == "always" and plan is None:
                    plan = "sublane"
            elif blocked_udedup_gate(u_pad, B, T):
                plan = "blocked"
        if plan is not None:
            uids, w = dedup_query_terms(term_ids, qtf)
            uw = (up(uids, np.int32), up(w, np.float32))
            if plan == "blocked":
                return ops.hybrid_rank_buckets_udedup(d, *uw, q, **kw)
            return ops.hybrid_rank_slots_udedup(d, *uw, q, variant=plan, **kw)
        if d.bm25_layout == "slots":
            return ops.hybrid_rank_slots(d, *dense_args(), q, **kw)
        return ops.hybrid_rank_buckets(d, *dense_args(), q, **kw)

    # --- public API ---------------------------------------------------------

    @staticmethod
    def _bucket(n: int) -> int:
        """Round batch up to a power of two (a bounded set of shapes)."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _to_artifact_order(self, idx, keep):
        """Permuted doc indices -> artifact doc indices where ``keep``."""
        perm = self._result_perm
        if perm is None:
            return idx
        return np.where(keep, perm[np.clip(idx, 0, len(perm) - 1)], idx)

    @staticmethod
    def _to_host(outs):
        return tuple(x.cpu().numpy() for x in outs)

    def rank_batch(self, queries: Sequence[str], augment: bool = True):
        """Device half of ``search_batch``: query prep + encode + ranking.
        Returns numpy (doc, fused, bm25_norm, win, valid) for
        ``finish_batch``.

        Batches larger than ``cfg.query_batch_size`` are chunked; every
        chunk is enqueued before the first is copied back.  A
        ``query_batch_size`` of None or 0 means chunks of 64, as in the
        reference.  A batch is one span of each stage, whatever its
        chunks: ``query_prep``, ``query_encode`` and ``device_rank``, the
        last split into ``rank_enqueue`` and ``rank_wait`` (the copies
        back, which wait for the device)."""
        cap = max(1, int(self.cfg.query_batch_size or 64))
        chunks = [list(queries[i : i + cap])
                  for i in range(0, len(queries), cap)] or [[]]
        self.times.begin_batch()
        with stage_timer("query_prep", self.times):
            prepped = [
                self.prepare_queries(
                    c + [""] * (self._bucket(len(c)) - len(c)), augment
                )
                for c in chunks
            ]
        with stage_timer("query_encode", self.times):
            qvecs = [self.encode_queries(p[2]) for p in prepped]
        with stage_timer("device_rank", self.times):
            with stage_timer("rank_enqueue", self.times):
                pending = [self._device_rank(t, f, q)
                           for (t, f, _), q in zip(prepped, qvecs)]
            with stage_timer("rank_wait", self.times):
                parts = [self._to_host(outs) for outs in pending]
        if len(parts) == 1:
            return parts[0]
        return tuple(
            np.concatenate(cols, axis=0)
            for cols in zip(*(
                tuple(x[: len(c)] for x in p) for c, p in zip(chunks, parts)
            ))
        )

    def search_batch(
        self,
        queries: Sequence[str],
        top_k: Optional[int] = None,
        augment: bool = True,
    ) -> List[List[RankedDoc]]:
        """Hybrid two-stage search for a batch of queries."""
        return self.finish_batch(
            self.rank_batch(queries, augment), queries, top_k
        )

    def _finish(self, raw, n_real: int, top_k: int, first_window: bool):
        """Every query's selected rows after dedup and diversification,
        in one native call that releases the interpreter lock (span
        ``finish_native``, one a batch)."""
        with stage_timer("finish_native", self.times):
            return self._finisher.run(
                raw, n_real, top_k,
                threshold=self.cfg.diversification_threshold,
                diversification=self.cfg.diversification,
                first_window=first_window,
            )

    def finish_batch(
        self,
        raw,
        queries: Sequence[str],
        top_k: Optional[int] = None,
    ) -> List[List[RankedDoc]]:
        """Host half of ``search_batch``: dedup + diversification over the
        candidate pool, RankedDoc rows for the top-k.  With a cross-encoder
        (stage 3), each query's rows are rescored jointly with the query
        and stably reordered by that score, which replaces
        ``similarity_score`` (``original_similarity`` stays)."""
        top_k = top_k or self.cfg.top_k_reranking
        n_wins = len(self.art.window_texts)
        out: List[List[RankedDoc]] = []
        with stage_timer("format_diversify", self.times):
            fin = self._finish(raw, len(queries), top_k, first_window=False)
            counts = fin.count.tolist()
            cols = (fin.doc.tolist(), fin.score.tolist(), fin.old.tolist(),
                    fin.win.tolist())
            for b, n in enumerate(counts):
                ranked: List[RankedDoc] = []
                for d, s, o, w in zip(*(c[b][:n] for c in cols)):
                    w_ok = 0 <= w < n_wins
                    ranked.append(
                        RankedDoc(
                            doc_id=self.art.doc_ids[d],
                            url=self.art.urls[d],
                            title=self.art.titles[d],
                            similarity_score=s,
                            original_similarity=o,
                            window_index=w if w_ok else 0,
                            window_text=self.art.window_texts[w] if w_ok else "",
                            domain=self.art.domains[d],
                        )
                    )
                if self.cross_encoder is not None and ranked:
                    ce = self.cross_encoder.rescore(
                        queries[b], [r.window_text for r in ranked]
                    )
                    ranked = sorted(  # stable: ties keep stage 2's order
                        (
                            dataclasses.replace(r, similarity_score=float(x))
                            for r, x in zip(ranked, ce)
                        ),
                        key=lambda r: -r.similarity_score,
                    )
                out.append(ranked)
        return out

    def search_batch_indices(
        self,
        queries: Sequence[str],
        top_k: Optional[int] = None,
        augment: bool = True,
    ) -> List[List[tuple]]:
        """``search_batch`` returning per-query ``(window_idx, score)`` pairs
        instead of RankedDoc rows; an out-of-range window maps to the
        doc's first chunk."""
        top_k = top_k or self.cfg.top_k_reranking
        raw = self.rank_batch(queries, augment=augment)
        with stage_timer("finish_indices", self.times):
            fin = self._finish(raw, len(queries), top_k, first_window=True)
            wins, scores = fin.win.tolist(), fin.score.tolist()
            return [list(zip(w[:n], s[:n]))
                    for w, s, n in zip(wins, scores, fin.count.tolist())]

    def search(self, query: str, top_k: Optional[int] = None) -> List[RankedDoc]:
        return self.search_batch([query], top_k=top_k)[0]

    def warmup(self, batch_sizes: Sequence[int] = (1, 64)) -> int:
        """Run the hot query shapes once before traffic arrives (the
        reference compiles them; here it builds the kernels and warms the
        allocator).  One throwaway batch per requested size with a short
        query (term bucket 4) and a long one (the largest bucket), plus an
        all-distinct batch that reaches the largest U-dedup bucket.
        Returns the number of batches run."""
        # warmup queries need REAL vocab terms: unknown terms are dropped
        # before term-axis bucketing, and the U-dedup bucket follows the
        # batch's distinct-term count
        T = self.cfg.max_query_terms
        vocab_terms = []
        for t in self.art.vocab.term_to_id:
            vocab_terms.append(t)
            if len(vocab_terms) >= max(batch_sizes, default=1) * T:
                break
        long_q = " ".join(vocab_terms[:T]) if vocab_terms else "warmup"
        calls = 0
        for b in batch_sizes:
            b = max(1, int(b))
            batches = [["warmup"] * b, [long_q] * b]
            if b > 1 and len(vocab_terms) >= b * T:
                batches.append(
                    [
                        " ".join(vocab_terms[i * T : (i + 1) * T])
                        for i in range(b)
                    ]
                )
            for qs in batches:
                self.search_batch(qs, top_k=1)
                calls += 1
        return calls

    def dense_search(self, query: str, top_k: int = 100, augment: bool = True):
        """Exact brute-force dense retrieval (no BM25 candidate filter):
        per-doc max cosine over every chunk in the bank."""
        pq = preprocess_query(query) if augment else query
        d = self.didx
        q = torch.as_tensor(
            self.encode_queries([pq]), dtype=torch.float32, device=self.device
        )
        k = min(top_k, d.n_docs_pad)
        backend = getattr(self, "_backend", None)
        if backend is not None:
            idx, vals, win = backend.dense_topk(q, k)
        elif d.buckets and self.use_pallas:
            idx, vals, win = ops.dense_rank_buckets(d, q, k=k)
        else:
            idx, vals, win = ops.dense_rank(
                d.chunk_emb, d.chunk_doc, q, n_docs_pad=d.n_docs_pad, k=k
            )
        idx, vals, win = self._to_host((idx, vals, win))
        idx = self._to_artifact_order(idx, np.isfinite(vals))
        out = []
        for di, v, w in zip(idx[0], vals[0], win[0]):
            if not np.isfinite(v) or int(di) >= len(self.art.doc_ids):
                continue
            di, w = int(di), int(w)
            w = w if 0 <= w < len(self.art.window_texts) else 0
            out.append(
                RankedDoc(
                    doc_id=self.art.doc_ids[di],
                    url=self.art.urls[di],
                    title=self.art.titles[di],
                    similarity_score=float(v),
                    original_similarity=0.0,
                    window_index=w,
                    window_text=self.art.window_texts[w],
                    domain=self.art.domains[di],
                )
            )
        return out[:top_k]

    def bm25_search(self, query: str, top_k: int = 1000, augment: bool = False):
        """Stage-1-only search through the resident layout's plain BM25
        kernel (1 or 7), or the CSR scatter (``use_pallas=False`` and every
        sharded engine).  Returns [{doc_id, score, text_snippet}]."""
        term_ids, qtf, _ = self.prepare_queries([query], augment=augment)
        d = self.didx
        k = min(top_k, d.n_docs_pad)
        backend = getattr(self, "_backend", None)
        if backend is not None:
            idx, vals = backend.bm25_topk(term_ids, qtf, k)
        else:
            topk = (ops.bm25_topk if not self.use_pallas
                    else ops.bm25_topk_slots if d.bm25_layout == "slots"
                    else ops.bm25_topk_blocked)
            idx, vals = topk(
                d,
                torch.as_tensor(term_ids, dtype=torch.int32,
                                device=self.device),
                torch.as_tensor(qtf, dtype=torch.float32, device=self.device),
                k,
            )
        idx, vals = self._to_host((idx, vals))
        idx = self._to_artifact_order(idx, vals >= 0)
        results = []
        for di, v in zip(idx[0], vals[0]):
            if v < 0:
                break  # keyed scores: inadmissible candidates are -1
            results.append(
                {
                    "doc_id": self.art.doc_ids[int(di)],
                    "score": float(v),
                    "text_snippet": self.art.snippets[int(di)],
                }
            )
        return results
