"""Global configuration.

The reference's three config surfaces — the constants module (reference
``config.py:1-24``), the reranker YAML (``reranker/config.yaml:1-41``) and
the assistant YAML (``search_assistant/config.yaml:1-23``) — collapsed
into one frozen, hashable dataclass.  The same fields and defaults as the
JAX package's ``config.py``; the constants fitted on a TPU (the approx
gate, the U-dedup dispatch) are kept as they are until they are refitted
on the GPU.

Behaviour-defining knobs and their reference sources:
  * window/step 512/450, embed dim 768     — config.py:2,10-11
  * BM25 k1=1.2 b=0.75                     — indexer/bm25_indexer.py:57
  * top-1000 retrieve -> top-100 rerank    — config.py:13-14
  * fusion smoothing 0.15 (0.85 cos + 0.15 bm25) — reranker/config.yaml:28
  * positional boost +10% / decay -5%      — reranker/reranker_api.py:317-318
  * diversification threshold 0.8, 1/domain — reranker/reranker_api.py:196-216
  * chunk cap 10 per document              — reranker/reranker_api.py:50-58
  * LLM window cap 10 x 4000 chars         — config.py:22, search_assistant/main.py:47
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # --- embedding / chunking ---
    embedding_dim: int = 768
    window_size: int = 512
    step_size: int = 450
    max_chunks_per_doc: int = 10  # reranker_api.py:50-58 ROW_NUMBER cap
    # encoder tokenizer vocabulary (hashing tokenizer; any tokenizer with
    # integer ids can be plugged in — chunking operates on token ids)
    vocab_size: int = 50257
    # --- BM25 ---
    k1: float = 1.2
    b: float = 0.75
    max_doc_chars: int = 1_000_000  # bm25_indexer.py:33 spaCy-limit analog
    # --- retrieval ---
    top_k_retrieval: int = 1000  # stage-1 BM25 candidates
    # approximate candidate selection (the reference's lax.approx_max_k):
    # "auto" (default) enables it only when the corpus reaches
    # approx_auto_min_docs; True/False pin it.  The port has no
    # approximate selection yet: True runs the exact top-k, which is what
    # the reference's lax.approx_max_k computes off the TPU.
    approx_candidates: object = "auto"
    # corpus size from which "auto" turns approximate selection on (a
    # threshold fitted on a TPU; not refitted for the GPU)
    approx_auto_min_docs: int = 500_000
    # U-dedup BM25 kernel: match postings against the batch's DISTINCT
    # query terms (exact scores).  True = auto (the udedup_plan gate in
    # engine._device_rank), "always" = pin the path, False = off.
    bm25_udedup: object = True
    # BM25 posting layout on device: "slots" (doc-slot stride classes) or
    # "blocked" (doc-major 128-doc blocks; kept for A/B).
    bm25_layout: str = "slots"
    top_k_reranking: int = 100  # stage-2 results
    max_query_terms: int = 16  # term slots per query (term axis cap)
    # --- fusion / rerank ---
    smoothing: float = 0.15  # new = 0.85*cos + 0.15*bm25
    positional_max_boost: float = 0.10
    positional_max_decay: float = 0.05
    diversification: bool = True
    diversification_threshold: float = 0.8
    diversification_max_per_domain: int = 1
    # --- batching ---
    embedding_batch_size: int = 64
    db_fetch_batch_size: int = 256
    bm25_fetch_batch_size: int = 5000
    query_batch_size: int = 64  # device query batch (reference P3 analog)
    # --- build gates ---
    use_bm25: bool = True  # reference USE_BM25 (config.py:24): skip the
    # sparse-stats build for dense-only indexes
    # --- LLM assistant ---
    llm_max_windows: int = 10
    llm_window_chars: int = 4000
    llm_max_tokens: int = 1500
    llm_enabled: bool = False  # external network call; off by default
    # --- serving ---
    host: str = "0.0.0.0"
    port: int = 5000
    # --- index layout ---
    doc_block: int = 2048  # doc-axis blocking for the Pallas BM25 kernel

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def resolve_approx(cfg: "Config", n_docs: int) -> bool:
    """Resolve the approx-candidates setting for a given chip-local
    corpus size ("auto" -> size gate; booleans pass through)."""
    if cfg.approx_candidates == "auto":
        return int(n_docs) >= int(cfg.approx_auto_min_docs)
    return bool(cfg.approx_candidates)


DEFAULT_CONFIG = Config()
