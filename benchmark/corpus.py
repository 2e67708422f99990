"""The deployment's index, made from the seed: the benchmark's own copy of
the bench corpus maker, drawn in a few large calls on the device.

Shape (``bench.py:67-149``, the port's ``synthetic.make_artifacts``): a
Zipf(``zipf``) vocabulary of ``n_terms`` terms whose term 0 is the most
frequent (the anchor "tuebingen" that query preprocessing appends to every
query), one posting per (term, doc) pair near ``nnz_target`` postings with
gamma(2, 1.5) impacts, 1 + Poisson(``avg_chunks`` - 1) windows a doc
capped at ``max_chunks``, unit-norm ``dim``-d window vectors rounded to
the bank's type, and window texts of ``window_words`` df-drawn words.

The corpus is plain arrays and strings.  ``run.py`` hands them to the
program read-only; the reference reads the same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

TEXT_POOL = 4096  # distinct window bodies; a window's text is "w<index> " + one of them
DOC_ID_BASE = 10**6  # external id of doc 0, as the bench corpus numbers them


def letters(n: int) -> str:
    s = ""
    n += 1
    while n:
        n, r = divmod(n - 1, 26)
        s = chr(ord("a") + r) + s
    return s


def vocabulary(n_terms: int) -> List[str]:
    """Term 0 is the anchor; the rest are analyzer-stable made-up words."""
    return ["tuebingen"] + [f"z{letters(i)}q" for i in range(n_terms - 1)]


def target_dfs(n_terms: int, nnz_target: int, n_docs: int, zipf: float):
    """Posting draws a term before duplicates collapse (Zipf by rank)."""
    ranks = np.arange(1, n_terms + 1)
    dfs = (1.0 / ranks) ** zipf
    dfs = np.maximum((dfs / dfs.sum() * nnz_target).astype(np.int64), 1)
    return np.minimum(dfs, n_docs)


class WindowTexts:
    """Window texts, read by index and ``len``: "w<index> " and one of
    ``TEXT_POOL`` bodies of twelve sentences of df-drawn words.  The
    leading word names the window, so a served snippet says which window
    was chosen."""

    def __init__(self, pool: List[str], n: int):
        self.pool, self.n = pool, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, w) -> str:
        w = int(w)
        if not 0 <= w < self.n:
            raise IndexError(w)
        return f"w{w} " + self.pool[(w * 2654435761) % len(self.pool)]


@dataclasses.dataclass
class Corpus:
    words: List[str]
    dfs: np.ndarray  # int64 [V] draws a term (the query model's weights)
    indptr: np.ndarray  # int32 [V+1]
    post_docs: np.ndarray  # int32 [nnz], ascending within a term
    post_impact: np.ndarray  # float32 [nnz]
    df: np.ndarray  # int32 [V]
    doc_len: np.ndarray  # int32 [D]
    chunk_emb: np.ndarray  # float32 [C, dim], bank-type values
    chunk_doc: np.ndarray  # int32 [C]
    doc_chunk_start: np.ndarray  # int32 [D]
    doc_n_chunks: np.ndarray  # int32 [D]
    urls: List[str]
    titles: List[str]
    domains: List[str]
    snippets: List[str]
    window_texts: WindowTexts

    @property
    def n_docs(self) -> int:
        return int(self.doc_n_chunks.shape[0])

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_emb.shape[0])

    def freeze(self) -> None:
        """Make every array read-only, so the program cannot change what
        the reference reads."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                v.setflags(write=False)


def make_corpus(seed: int, spec: dict, device) -> Corpus:
    """The corpus of a configuration's ``corpus`` block, from ``seed``."""
    n_docs, n_terms = spec["n_docs"], spec["n_terms"]
    dim = spec["dim"]
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    dfs = target_dfs(n_terms, spec["nnz_target"], n_docs, spec["zipf"])

    # postings: one per (term, doc); duplicate draws collapse
    term_rep = torch.repeat_interleave(
        torch.arange(n_terms, device=dev), torch.as_tensor(dfs, device=dev)
    )
    draws = torch.randint(0, n_docs, (term_rep.numel(),), generator=g,
                          device=dev)
    pairs = torch.unique(term_rep * n_docs + draws)  # sorted
    del term_rep, draws
    post_docs = (pairs % n_docs).to(torch.int32)
    df = torch.bincount(pairs // n_docs, minlength=n_terms).to(torch.int32)
    del pairs
    # gamma(2, 1.5) as the sum of two exponentials; the logs in float64,
    # so a vectorised log's last bit does not reach the float32 impact
    u = 1.0 - torch.rand((2, post_docs.numel()), generator=g, device=dev)
    impact = (-1.5 * torch.log(u.double()).sum(0)).to(torch.float32)
    del u

    n_extra = torch.poisson(
        torch.full((n_docs,), spec["avg_chunks"] - 1.0, device=dev),
        generator=g,
    )
    doc_n = torch.clamp(1 + n_extra.to(torch.int32), max=spec["max_chunks"])
    n_chunks = int(doc_n.sum())
    emb = torch.randn((n_chunks, dim), generator=g, device=dev)
    emb = emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True)
    emb = emb.to(getattr(torch, spec["bank_dtype"])).to(torch.float32)

    post_docs_np = post_docs.cpu().numpy()
    df_np = df.cpu().numpy()
    doc_n_np = doc_n.cpu().numpy()
    indptr = np.zeros(n_terms + 1, np.int32)
    np.cumsum(df_np, out=indptr[1:])
    doc_start = np.zeros(n_docs, np.int32)
    np.cumsum(doc_n_np[:-1], out=doc_start[1:])

    words = vocabulary(n_terms)
    n_dom = spec["n_domains"]
    rng = np.random.default_rng([int(seed), 1])
    cdf = np.cumsum(dfs[1:] / dfs[1:].sum())
    per = spec["window_words"]
    ids = 1 + np.minimum(np.searchsorted(cdf, rng.random((TEXT_POOL, per))),
                         len(cdf) - 1)
    warr = np.array(words, dtype=object)
    pool = [
        " ".join(" ".join(row[k : k + 12]) + "." for k in range(0, per, 12))
        for row in warr[ids].tolist()
    ]
    return Corpus(
        words=words,
        dfs=dfs,
        indptr=indptr,
        post_docs=post_docs_np,
        post_impact=impact.cpu().numpy(),
        df=df_np,
        doc_len=np.bincount(post_docs_np, minlength=n_docs).astype(np.int32),
        chunk_emb=emb.cpu().numpy(),
        chunk_doc=np.repeat(np.arange(n_docs, dtype=np.int32), doc_n_np),
        doc_chunk_start=doc_start,
        doc_n_chunks=doc_n_np,
        urls=[f"https://www.site{i % n_dom}.de/page{i}" for i in range(n_docs)],
        titles=[f"page {i}" for i in range(n_docs)],
        domains=[f"www.site{i % n_dom}.de" for i in range(n_docs)],
        snippets=[f"page {i}: ..." for i in range(n_docs)],
        window_texts=WindowTexts(pool, n_chunks),
    )
