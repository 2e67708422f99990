"""SearchEngine: host orchestration around the torch hybrid query path.

Counterpart of the reference package's ``retrieval/engine.py`` for its
default configuration (``bm25_layout="slots"``, ``bm25_udedup=True``, exact
top-k): query preprocessing and term lookup on the host, then BM25 through
one of the three slot kernels, the bucketed dense tail with the stats
kernel, and host-side dedup, domain diversification and result formatting
over the (at most) ``top_k_retrieval`` candidates.

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
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    dedup_query_terms,
    u_pad_for,
    udedup_plan,
)
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    DeviceIndex,
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
            artifacts, self.cfg, bank_dtype=bank_dtype, device=device
        )
        self.device = self.didx.device
        self.k_ret = min(self.cfg.top_k_retrieval, self.didx.n_docs_pad)
        self._approx = resolve_approx(self.cfg, self.didx.n_docs_pad)
        self.times = StageTimes()
        # results come back in the bucketed (permuted) doc order
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

    def encode_queries(self, processed: Sequence[str]) -> np.ndarray:
        """Unit-norm query embeddings [B, dim] from a host encoder."""
        q = np.asarray(self.encoder.encode_batch(list(processed)), np.float32)
        norms = np.linalg.norm(q, axis=1, keepdims=True)
        return q / np.maximum(norms, 1e-12)

    # --- device calls -------------------------------------------------------

    def _device_rank(self, term_ids, qtf, qvec):
        """One batch through the slot path; returns device tensors
        (doc, fused, bm25_norm, win, valid), each [B, k_ret]."""
        d = self.didx
        if self.cfg.bm25_layout != "slots":
            raise NotImplementedError(
                "bm25_layout='blocked' (kernels _kernel/_kernel_udedup) is "
                "not ported yet"
            )
        dev = self.device
        q = torch.as_tensor(qvec, dtype=torch.float32, device=dev)
        kw = dict(k_ret=self.k_ret, smoothing=self.cfg.smoothing,
                  approx=self._approx)
        tids_np = np.asarray(term_ids)
        if self.cfg.bm25_udedup:
            B = tids_np.shape[0]
            u_pad = u_pad_for(int(np.unique(tids_np[tids_np >= 0]).size))
            plan = udedup_plan(u_pad, B)
            if self.cfg.bm25_udedup == "always" and plan is None:
                plan = "sublane"
            if plan is not None:
                uids, w = dedup_query_terms(term_ids, qtf)
                return ops.hybrid_rank_slots_udedup(
                    d,
                    torch.as_tensor(uids, device=dev),
                    torch.as_tensor(w, device=dev),
                    q,
                    variant=plan,
                    **kw,
                )
        return ops.hybrid_rank_slots(
            d,
            torch.as_tensor(tids_np, dtype=torch.int32, device=dev),
            torch.as_tensor(np.asarray(qtf), dtype=torch.float32, device=dev),
            q,
            **kw,
        )

    # --- public API ---------------------------------------------------------

    @staticmethod
    def _bucket(n: int) -> int:
        """Round batch up to a power of two (a bounded set of shapes)."""
        b = 1
        while b < n:
            b *= 2
        return b

    @staticmethod
    def _to_host(outs):
        return tuple(x.cpu().numpy() for x in outs)

    def rank_batch(self, queries: Sequence[str], augment: bool = True):
        """Device half of ``search_batch``: query prep + encode + ranking.
        Returns numpy (doc, fused, bm25_norm, win, valid) for
        ``finish_batch``.

        Batches larger than ``cfg.query_batch_size`` are chunked; every
        chunk is enqueued before the first is copied back."""
        cap = max(1, int(self.cfg.query_batch_size))
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
        perm = self._result_perm
        doc = np.where(valid, perm[np.clip(doc, 0, len(perm) - 1)], doc)
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
