"""Index builder: raw documents -> array-native hybrid index artifacts.

TPU-first re-design of the reference's offline build (``index_all.py`` →
``indexer/bm25_indexer.py:252`` + ``indexer/indexer.py:24``): instead of
four DuckDB BM25 tables and two chunk/embedding tables, the build emits

  * a term-major CSR postings matrix with **precomputed BM25 impact scores**
    (idf and the tf/length saturation folded in at build time — query-time
    scoring is then a pure gather+scatter-add, no per-posting math beyond a
    qtf multiply), and
  * a dense doc-major chunk-embedding bank ``[n_chunks, dim]`` with
    contiguous per-document chunk segments (so per-doc pooling is a sorted
    segment reduction on device).

Formula parity with the reference:
  idf   = ln((N - df + 0.5) / (df + 0.5))            bm25_indexer.py:140
  tf'   = tf(k1+1) / (tf + k1(1 - b + b·dl/avgdl))   bm25_indexer.py:471-474
  score = Σ_terms idf·tf'·qtf                         bm25_indexer.py:477-479
Chunking parity: 512-token windows / 450 step with tail window
(embedder.py:65-87); documents embed ``title + " " + text``
(indexer.py:101-111); chunks per doc capped at ``max_chunks_per_doc`` — the
reference applies the same cap-10 at query time via ROW_NUMBER in the
reranker SQL (reranker_api.py:50-58), we apply it at build time which is
score-equivalent and smaller.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Sequence, Tuple
from urllib.parse import urlparse

import numpy as np

from modern_search_engines_project_tpu_torch.config import Config, DEFAULT_CONFIG
from modern_search_engines_project_tpu_torch.index.vocab import TermDictionary
from modern_search_engines_project_tpu_torch.text.analyzer import Analyzer
from modern_search_engines_project_tpu_torch.text.chunker import (
    sliding_window_bounds,
)
from modern_search_engines_project_tpu_torch.text.hash_tokenizer import HashTokenizer


@dataclasses.dataclass
class Document:
    doc_id: int
    url: str
    title: str
    text: str


def extract_domain(url: str) -> str:
    """Parity with reranker_api.py extract_domain (urlparse netloc, lower)."""
    try:
        return urlparse(url).netloc.lower()
    except Exception:
        return "defaultdomain"


def make_snippet(title: str, text: str) -> str:
    """Parity with bm25_indexer.py:505-508 snippet format."""
    snippet = f"{title or 'N/A'}: {(text or '')[:200]}"
    if len(text or "") > 200:
        snippet += "..."
    return snippet


@dataclasses.dataclass
class IndexArtifacts:
    """Everything the device engine + serving layer need, as plain arrays."""

    # --- BM25 (term-major CSR, impact-ordered postings) ---
    indptr: np.ndarray  # int32 [V+1]
    post_docs: np.ndarray  # int32 [nnz]
    post_impact: np.ndarray  # float32 [nnz] = idf * tf_saturation
    idf: np.ndarray  # float32 [V]  (introspection parity: get_term_stats)
    df: np.ndarray  # int32 [V]
    doc_len: np.ndarray  # int32 [n_docs]
    avgdl: float
    # --- dense chunk bank (doc-major contiguous segments) ---
    chunk_emb: np.ndarray  # float32 [n_chunks, dim], L2-normalized rows
    chunk_doc: np.ndarray  # int32 [n_chunks]
    doc_chunk_start: np.ndarray  # int32 [n_docs]
    doc_n_chunks: np.ndarray  # int32 [n_docs]
    # --- host-side metadata ---
    vocab: TermDictionary
    doc_ids: List[int]  # external ids (reference urlsDB.id analog)
    urls: List[str]
    titles: List[str]
    domains: List[str]
    snippets: List[str]
    window_texts: List[str]  # text of each chunk (aligned with chunk_emb)
    config: Config = DEFAULT_CONFIG
    # provenance of the encoder that produced chunk_emb (encoder.describe());
    # serving refuses to pair the index with a mismatched query encoder
    encoder_meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_emb.shape[0])

    @property
    def n_terms(self) -> int:
        return int(self.indptr.shape[0]) - 1

    def index_stats(self) -> dict:
        """Parity with BM25.get_index_stats (bm25_indexer.py:546-568)."""
        return {
            "total_documents": self.n_docs,
            "unique_terms": self.n_terms,
            "total_postings": int(self.post_docs.shape[0]),
            "avg_doc_length": float(self.avgdl),
            "total_chunks": self.n_chunks,
            "embedding_dim": int(self.chunk_emb.shape[1]),
        }

    def get_term_stats(self, term: str) -> Optional[dict]:
        """Per-term stats (BM25.get_term_stats parity,
        bm25_indexer.py:516-531)."""
        tid = self.vocab.get(term)
        if tid < 0:
            return None
        return {
            "term": term,
            "doc_freq": int(self.df[tid]),
            "idf": float(self.idf[tid]),
            "postings": int(self.indptr[tid + 1] - self.indptr[tid]),
        }

    def get_document_terms(self, doc_id: int, top_n: int = 20) -> List[dict]:
        """Highest-impact terms of a document (BM25.get_document_terms
        parity, bm25_indexer.py:533-544).

        One vectorized pass: find this doc's posting rows with a single
        nnz-length mask, map them to term ids by searchsorted into the CSR
        indptr.  (The old per-term python scan was O(V * nnz) — it would
        wedge on a 1M-doc index if the UI called it per result.)"""
        try:
            internal = self.doc_ids.index(doc_id)
        except ValueError:
            return []
        pos = np.nonzero(np.asarray(self.post_docs) == internal)[0]
        if pos.size == 0:
            return []
        tids = np.searchsorted(np.asarray(self.indptr), pos, side="right") - 1
        impacts = np.asarray(self.post_impact)[pos]
        id_to_term = {v: k for k, v in self.vocab.term_to_id.items()}
        order = np.argsort(-np.abs(impacts), kind="stable")[:top_n]
        return [
            {"term": id_to_term[int(tids[i])], "impact": float(impacts[i])}
            for i in order
        ]


def build_bm25_csr(
    term_counts: List[dict], cfg: Config
) -> Tuple[
    Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, float],
    TermDictionary,
]:
    """Vectorized term-major CSR postings build from per-doc term counts.

    Shared by the one-shot ``IndexBuilder`` and the sharded
    ``BuildPipeline.merge`` (the global-stats reduction): the only Python
    loop is dictionary assignment; the (doc, term, tf) triples flatten once
    and a single lexsort produces impact-ordered postings.  Formula parity:
    idf = LOG((N - df + 0.5) / (df + 0.5)) (bm25_indexer.py:140), impact =
    idf * tf(k1+1)/(tf + k1(1-b+b*dl/avgdl)) (bm25_indexer.py:459-481).
    """
    n_docs = len(term_counts)
    vocab = TermDictionary()
    doc_len = np.array([sum(c.values()) for c in term_counts], dtype=np.int32)
    avgdl = float(doc_len.mean()) if n_docs else 0.0

    # first pass: dictionary + df
    df_list: List[int] = []
    for counts in term_counts:
        for term in counts:
            tid = vocab.add(term)
            if tid == len(df_list):
                df_list.append(0)
            df_list[tid] += 1
    V = len(vocab)
    df = np.array(df_list, dtype=np.int32) if V else np.zeros(0, np.int32)
    idf = (
        np.log((n_docs - df + 0.5) / (df + 0.5)).astype(np.float32)
        if V
        else np.zeros(0, np.float32)
    )

    # second pass: vectorized CSR build.  Flatten (doc, term, tf) rows once,
    # then sort by (term, -|impact|) in a single lexsort — a per-doc python
    # fill loop would dominate host build time at 1M docs.
    t2i = vocab.term_to_id
    tids = np.fromiter(
        (t2i[t] for c in term_counts for t in c),
        dtype=np.int64,
        count=sum(len(c) for c in term_counts),
    )
    docs_flat = np.repeat(
        np.arange(n_docs, dtype=np.int32),
        [len(c) for c in term_counts],
    )
    tfs = np.fromiter(
        (tf for c in term_counts for tf in c.values()),
        dtype=np.float32,
        count=tids.shape[0],
    )
    nnz = int(tids.shape[0])
    k1, b = cfg.k1, cfg.b
    if avgdl > 0:
        len_norm = k1 * (1.0 - b + b * doc_len.astype(np.float64) / avgdl)
    else:
        len_norm = np.full(n_docs, k1)
    impacts = (
        idf[tids] * (tfs * (k1 + 1.0)) / (tfs + len_norm[docs_flat])
    ).astype(np.float32)

    # term-major, impact-ordered within each term (descending |impact| keeps
    # graceful degradation if a query's gather budget overflows)
    order = np.lexsort((-np.abs(impacts), tids))
    post_docs = docs_flat[order]
    post_impact = impacts[order]
    indptr = np.zeros(V + 1, dtype=np.int64)
    np.add.at(indptr[1:], tids, 1)
    indptr = np.cumsum(indptr)

    return (
        indptr.astype(np.int32) if nnz < 2**31 else indptr,
        post_docs,
        post_impact,
        idf,
        df,
        doc_len,
        avgdl,
    ), vocab


class IndexBuilder:
    """Builds IndexArtifacts from an iterable of Documents.

    The encoder is pluggable: anything with
    ``encode_batch(list[str]) -> float32 [n, dim]`` (HashingEncoder for
    self-contained builds, the JAX bi-encoder for trained embeddings).
    """

    def __init__(
        self,
        encoder,
        config: Config = DEFAULT_CONFIG,
        analyzer: Optional[Analyzer] = None,
        tokenizer: Optional[HashTokenizer] = None,
    ):
        self.config = config
        self.encoder = encoder
        self.analyzer = analyzer or Analyzer()
        self.tokenizer = tokenizer or HashTokenizer(config.vocab_size)

    # -- BM25 side -----------------------------------------------------------

    def _build_bm25(
        self, term_counts: List[dict]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
        return build_bm25_csr(term_counts, self.config)

    # -- dense side ----------------------------------------------------------

    def _build_dense(self, docs: Sequence[Document]):
        cfg = self.config
        window_texts: List[str] = []
        window_ids: List[np.ndarray] = []
        chunk_doc: List[int] = []
        doc_chunk_start = np.zeros(len(docs), dtype=np.int32)
        doc_n_chunks = np.zeros(len(docs), dtype=np.int32)
        _EMPTY = np.zeros(0, dtype=np.int64)
        for d, doc in enumerate(docs):
            full = f"{doc.title} {doc.text}" if doc.title else doc.text
            ids, offsets = self.tokenizer.encode_with_offsets(full)
            ids = np.asarray(ids, dtype=np.int64)
            bounds = sliding_window_bounds(
                len(offsets), cfg.window_size, cfg.step_size
            )[: cfg.max_chunks_per_doc]
            doc_chunk_start[d] = len(window_texts)
            doc_n_chunks[d] = len(bounds)
            for s, e in bounds:
                if e > s:
                    c0, c1 = offsets[s][0], offsets[e - 1][1]
                    window_texts.append(full[c0:c1])
                    window_ids.append(ids[s:e])
                else:  # empty doc: one empty window keeps shapes consistent
                    window_texts.append("")
                    window_ids.append(_EMPTY)
                chunk_doc.append(d)
            if not bounds:  # fully empty document still gets one chunk
                window_texts.append("")
                window_ids.append(_EMPTY)
                chunk_doc.append(d)
                doc_n_chunks[d] = 1

        # pre-tokenized fast path: window spans start/end on token
        # boundaries, so re-tokenizing the span text reproduces ids[s:e]
        # exactly — skip the text round-trip when the encoder tokenizes
        # with the same hash vocab (HashingEncoder; the trained JaxEncoder
        # has its own tokenizer and takes the text path)
        use_ids = (
            hasattr(self.encoder, "encode_id_batch")
            and getattr(
                getattr(self.encoder, "tokenizer", None), "vocab_size", None
            )
            == self.tokenizer.vocab_size
        )
        embs = []
        bs = cfg.embedding_batch_size
        for i in range(0, len(window_texts), bs):
            batch = (
                self.encoder.encode_id_batch(window_ids[i : i + bs])
                if use_ids
                else self.encoder.encode_batch(window_texts[i : i + bs])
            )
            embs.append(np.asarray(batch, dtype=np.float32))
        chunk_emb = (
            np.concatenate(embs, axis=0)
            if embs
            else np.zeros((0, cfg.embedding_dim), np.float32)
        )
        # L2-normalize (reference encodes with normalize_embeddings=True,
        # indexer.py:165)
        norms = np.linalg.norm(chunk_emb, axis=1, keepdims=True)
        chunk_emb = np.where(norms > 0, chunk_emb / np.maximum(norms, 1e-12), chunk_emb)
        return (
            chunk_emb,
            np.array(chunk_doc, dtype=np.int32),
            doc_chunk_start,
            doc_n_chunks,
            window_texts,
        )

    # -- public --------------------------------------------------------------

    def build(self, documents: Iterable[Document]) -> IndexArtifacts:
        docs = list(documents)
        if self.config.use_bm25:
            term_counts = self.analyzer.analyze_batch(
                (f"{d.title} {d.text}" if d.title else d.text) for d in docs
            )
        else:  # USE_BM25=False: dense-only index (reference config.py:24)
            term_counts = [{} for _ in docs]
        (indptr, post_docs, post_impact, idf, df, doc_len, avgdl), vocab = (
            self._build_bm25(term_counts)
        )
        chunk_emb, chunk_doc, doc_chunk_start, doc_n_chunks, window_texts = (
            self._build_dense(docs)
        )
        return IndexArtifacts(
            indptr=indptr,
            post_docs=post_docs,
            post_impact=post_impact,
            idf=idf,
            df=df,
            doc_len=doc_len,
            avgdl=avgdl,
            chunk_emb=chunk_emb,
            chunk_doc=chunk_doc,
            doc_chunk_start=doc_chunk_start,
            doc_n_chunks=doc_n_chunks,
            vocab=vocab,
            doc_ids=[d.doc_id for d in docs],
            urls=[d.url for d in docs],
            titles=[d.title for d in docs],
            domains=[extract_domain(d.url) for d in docs],
            snippets=[make_snippet(d.title, d.text) for d in docs],
            window_texts=window_texts,
            config=self.config,
            encoder_meta=getattr(self.encoder, "describe", dict)(),
        )
