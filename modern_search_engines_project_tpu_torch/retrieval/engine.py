"""SearchEngine: host orchestration around the torch hybrid query path.

Counterpart of the reference package's ``retrieval/engine.py`` on its
kernel path: query preprocessing and term lookup on the host, then BM25
through one of the slot kernels (``bm25_layout="slots"``, the default) or
the blocked kernels (``bm25_layout="blocked"``, and every index without
chunk buckets), the bucketed dense tail with the stats kernel (or, without
buckets, the packed-bank tail), and host-side dedup, domain
diversification and result formatting over the (at most)
``top_k_retrieval`` candidates.  ``bm25_search`` and ``dense_search`` run
one stage alone.

Runs on the card unless the caller passes ``device="cpu"``, where every
kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import numpy as np
import torch

from modern_search_engines_project_tpu_torch.config import Config, resolve_approx
from modern_search_engines_project_tpu_torch.index.builder import IndexArtifacts
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
    finish_positions,
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
        bank_dtype: Optional[torch.dtype] = None,
        analyzer: Optional[Analyzer] = None,
        device=None,
    ):
        """``device``: "cuda" (default) or "cpu"; with no card and no
        ``device="cpu"`` this raises.  ``bank_dtype`` defaults to bf16 on
        the card and f32 on the CPU."""
        self.art = artifacts
        self.cfg = config or artifacts.config
        self.encoder = encoder
        self.analyzer = analyzer or Analyzer()
        self.didx = DeviceIndex.from_artifacts(
            artifacts, self.cfg, bank_dtype=bank_dtype, device=device,
            bm25_layout=self.cfg.bm25_layout,
        )
        self.device = self.didx.device
        self.k_ret = min(self.cfg.top_k_retrieval, self.didx.n_docs_pad)
        self._approx = resolve_approx(self.cfg, self.didx.n_docs_pad)
        self.times = StageTimes()
        # results come back in the bucketed (permuted) doc order; an index
        # without buckets keeps the artifact order (doc_perm None)
        self._result_perm = self.didx.doc_perm
        self._domain_codes = factorize(self.art.domains)
        self._base_codes = factorize(
            [u.split("?", 1)[0] for u in self.art.urls]
        )

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
        Host encoders give numpy, normalised on the host."""
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
        reference."""
        cap = max(1, int(self.cfg.query_batch_size or 64))
        if len(queries) > cap:
            pending = []
            for i in range(0, len(queries), cap):
                chunk = list(queries[i : i + cap])
                padded = chunk + [""] * (self._bucket(len(chunk)) - len(chunk))
                term_ids, qtf, processed = self.prepare_queries(
                    padded, augment
                )
                qvec = self.encode_queries(processed)
                pending.append(
                    (len(chunk), self._device_rank(term_ids, qtf, qvec))
                )
            parts = [
                tuple(x[:n] for x in self._to_host(outs))
                for n, outs in pending
            ]
            return tuple(
                np.concatenate(cols, axis=0) for cols in zip(*parts)
            )
        n_real = len(queries)
        padded = list(queries) + [""] * (self._bucket(n_real) - n_real)
        with stage_timer("query_prep", self.times):
            term_ids, qtf, processed = self.prepare_queries(padded, augment)
        with stage_timer("query_encode", self.times):
            qvec = self.encode_queries(processed)
        with stage_timer("device_rank", self.times):
            return self._to_host(self._device_rank(term_ids, qtf, qvec))

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

    def _finish_rows(self, raw, n_real: int, top_k: int):
        """Per query: (doc idx, fused score, bm25_norm, window) of the
        selected rows after dedup and diversification."""
        doc, vals, old, win, valid = raw
        doc = self._to_artifact_order(doc, valid)
        n_valid = valid.sum(axis=1).tolist()
        n_docs_real = len(self.art.doc_ids)
        for b in range(n_real):
            nv = n_valid[b]
            db = doc[b, :nv]
            ok = (db >= 0) & (db < n_docs_real)
            pos0 = np.nonzero(ok)[0]
            db = db[pos0]
            sel, sc = finish_positions(
                vals[b, :nv][pos0],
                self._domain_codes[db],
                self._base_codes[db],
                top_k,
                relevance_threshold=self.cfg.diversification_threshold,
                diversification=self.cfg.diversification,
            )
            yield db[sel], sc, old[b, :nv][pos0][sel], win[b, :nv][pos0][sel]

    def finish_batch(
        self,
        raw,
        queries: Sequence[str],
        top_k: Optional[int] = None,
    ) -> List[List[RankedDoc]]:
        """Host half of ``search_batch``: dedup + diversification over the
        candidate pool, RankedDoc rows for the top-k."""
        top_k = top_k or self.cfg.top_k_reranking
        n_wins = len(self.art.window_texts)
        out: List[List[RankedDoc]] = []
        with stage_timer("format_diversify", self.times):
            for d_sel, sc, o_sel, w_sel in self._finish_rows(
                raw, len(queries), top_k
            ):
                ranked: List[RankedDoc] = []
                for d, s, o, w in zip(
                    d_sel.tolist(), sc.tolist(), o_sel.tolist(),
                    w_sel.tolist(),
                ):
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
        n_wins = len(self.art.window_texts)
        start = self.art.doc_chunk_start
        out: List[List[tuple]] = []
        for d_sel, sc, _o, w_sel in self._finish_rows(raw, len(queries), top_k):
            bad = (w_sel < 0) | (w_sel >= n_wins)
            w_sel = np.where(bad, start[d_sel], w_sel)
            out.append(list(zip(w_sel.tolist(), sc.tolist())))
        return out

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
        if d.buckets:
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
        kernel (1 or 7).  Returns [{doc_id, score, text_snippet}]."""
        term_ids, qtf, _ = self.prepare_queries([query], augment=augment)
        d = self.didx
        topk = (ops.bm25_topk_slots if d.bm25_layout == "slots"
                else ops.bm25_topk_blocked)
        idx, vals = topk(
            d,
            torch.as_tensor(term_ids, dtype=torch.int32, device=self.device),
            torch.as_tensor(qtf, dtype=torch.float32, device=self.device),
            min(top_k, d.n_docs_pad),
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
