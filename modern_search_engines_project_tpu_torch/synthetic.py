"""A synthetic index in the shape of the repository's bench corpus.

``make_artifacts`` builds ``IndexArtifacts`` from a seed with the 100k-doc
scale of the JAX package's ``bench.py`` (``make_synthetic_index``) when
called with its defaults: 100,000 docs, a 50,000-term Zipf(0.7)
vocabulary whose term 0 is the most frequent (the anchor "tuebingen" that
query preprocessing appends to every query), an 8M-posting target (one
posting per (term, doc) pair, gamma(2, 1.5) impacts), 1 + Poisson(2)
chunks per doc capped at 10, and unit-norm 768-d chunk vectors.
``chip_smoke.py`` and ``bench_kernels`` build the same index with it.
``sample_terms`` and ``query_strings`` draw the bench's queries.
"""

from __future__ import annotations

import numpy as np

from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import IndexArtifacts
from modern_search_engines_project_tpu_torch.index.vocab import TermDictionary
from modern_search_engines_project_tpu_torch.text.analyzer import Analyzer


def _letters(n: int) -> str:
    s = ""
    n += 1
    while n:
        n, r = divmod(n - 1, 26)
        s = chr(ord("a") + r) + s
    return s


def make_artifacts(seed, n_docs=100_000, n_terms=50_000, nnz_target=8_000_000,
                   avg_chunks=3.0, dim=768):
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
    if not all(an.tokens(w) == [w] for w in words):
        raise RuntimeError("synthetic vocabulary is not analyzer-stable")
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


def sample_terms(rng, dfs, B, T, by_df=True, pool=None):
    """Per query 1-5 terms (by document frequency, or uniform), as in the
    bench's query model, or 2-5 distinct terms from the ``pool`` most
    frequent ones (a batch sharing terms); returns (term_ids [B, T] pad -1,
    qtf [B, T])."""
    n_terms = len(dfs)
    probs = dfs / dfs.sum() if by_df else None
    top = np.argsort(-dfs[1:], kind="stable")[: pool or 1] + 1
    tids = np.full((B, T), -1, np.int32)
    qtf = np.zeros((B, T), np.float32)
    for b in range(B):
        n_q = int(rng.integers(1, 6)) if by_df else T - 1
        if pool:
            draw = rng.choice(top, int(rng.integers(2, 6)), replace=False)
        else:
            draw = rng.choice(n_terms, size=n_q, p=probs)
        draws = np.concatenate([[0], draw])
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
