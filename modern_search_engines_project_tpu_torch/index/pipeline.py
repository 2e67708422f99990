"""Sharded, resumable index-build pipeline (reference ``index_all.py`` analog).

The reference builds its index with a multiprocessing pool over spaCy
(bm25_indexer.py:181-217, P1) and GPU batch embedding (indexer.py:155-171,
P4), resuming via LEFT-JOIN anti-joins (SURVEY.md §5.4).  The pipeline:

  * documents are partitioned into contiguous **shards**;
  * each shard is analyzed (host, C++-accelerated analyzer), embedded
    (batch encode, where the encoder runs) and persisted as a *raw* shard
    file;
  * resume = skip shards whose raw file already exists (the array-native
    version of "only process docs missing from bm25_doc_stats");
  * a cheap merge pass derives global corpus statistics (df, idf, avgdl —
    the psum-style reduction, here a host add over shard partials) and
    emits the final ``IndexArtifacts`` with precomputed impacts.

Stats note: idf and the BM25 length saturation depend on *global* df and
avgdl, so impacts can only be computed at merge time — shards store raw
(term, tf) postings.

Counterpart of the reference package's ``index/pipeline.py``.  The shard
files are the reference's (the same pickled payload of numpy arrays,
lists and dicts, written to ``.tmp`` and renamed), so either package
resumes a build the other began.  Embedding runs wherever the encoder
does: a ``TorchEncoder`` on its device, the ``HashingEncoder`` on the
host; with ``mesh`` a ``TorchEncoder``'s batches are split over the
mesh's devices (``DataParallelEncoder``).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from modern_search_engines_project_tpu_torch.config import Config, DEFAULT_CONFIG
from modern_search_engines_project_tpu_torch.index.builder import (
    Document,
    IndexArtifacts,
    build_bm25_csr,
    extract_domain,
    make_snippet,
)
from modern_search_engines_project_tpu_torch.text.analyzer import Analyzer
from modern_search_engines_project_tpu_torch.text.chunker import (
    sliding_window_bounds,
)
from modern_search_engines_project_tpu_torch.text.hash_tokenizer import HashTokenizer


class DataParallelEncoder:
    """Wraps an ``encode_batch`` model for the pipeline.

    With a ``mesh`` (``parallel.sharding.Mesh``) and a ``TorchEncoder``,
    each batch is split over the mesh's devices as
    ``parallel.sharding.ShardedQueryEncoder`` splits a query batch (one
    replica a distinct device), and the raw embeddings come back in the
    original order; otherwise batches go to the encoder as they are (a
    ``TorchEncoder`` runs them on its own device, a host encoder on the
    host)."""

    def __init__(self, encoder, mesh=None):
        from modern_search_engines_project_tpu_torch.models.encoder import (
            TorchEncoder,
        )
        from modern_search_engines_project_tpu_torch.parallel.sharding import (
            Mesh,
            ShardedQueryEncoder,
        )

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh: a parallel.sharding.Mesh, not {mesh!r}")
        self.encoder = encoder
        self.dim = getattr(encoder, "dim", None)
        self._split = None
        if mesh is not None and isinstance(encoder, TorchEncoder):
            self._split = ShardedQueryEncoder(encoder, mesh)

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        if self._split is None:
            return self.encoder.encode_batch(texts)
        parts = self._split.encode_parts(texts)
        return torch.cat([p.cpu() for p in parts]).numpy()[: len(texts)]


class BuildPipeline:
    def __init__(
        self,
        encoder,
        out_dir: str,
        config: Config = DEFAULT_CONFIG,
        shard_size: int = 1024,
        analyzer: Optional[Analyzer] = None,
        tokenizer: Optional[HashTokenizer] = None,
        mesh=None,
    ):
        self.cfg = config
        self.out_dir = out_dir
        self.shard_size = shard_size
        self.analyzer = analyzer or Analyzer()
        self.tokenizer = tokenizer or HashTokenizer(config.vocab_size)
        self.encoder = DataParallelEncoder(encoder, mesh)
        os.makedirs(os.path.join(out_dir, "shards"), exist_ok=True)

    # --- shard stage --------------------------------------------------------

    def _shard_path(self, i: int) -> str:
        return os.path.join(self.out_dir, "shards", f"shard_{i:05d}.pkl")

    def build_shard(self, i: int, docs: List[Document]) -> str:
        """Analyze + chunk + embed one shard; persist raw stats."""
        path = self._shard_path(i)
        if os.path.exists(path):
            return path  # resume: already built (LEFT-JOIN-skip analog)
        cfg = self.cfg
        term_counts = []
        window_texts: List[str] = []
        chunk_doc_local: List[int] = []
        doc_n_chunks = []
        for d_local, doc in enumerate(docs):
            full = f"{doc.title} {doc.text}" if doc.title else doc.text
            term_counts.append(
                self.analyzer.count(full) if cfg.use_bm25 else {}
            )
            _ids, offsets = self.tokenizer.encode_with_offsets(full)
            bounds = sliding_window_bounds(
                len(offsets), cfg.window_size, cfg.step_size
            )[: cfg.max_chunks_per_doc]
            n = 0
            for s, e in bounds:
                if e > s:
                    window_texts.append(full[offsets[s][0] : offsets[e - 1][1]])
                else:
                    window_texts.append("")
                chunk_doc_local.append(d_local)
                n += 1
            if n == 0:
                window_texts.append("")
                chunk_doc_local.append(d_local)
                n = 1
            doc_n_chunks.append(n)

        embs = []
        bs = cfg.embedding_batch_size
        for s in range(0, len(window_texts), bs):
            embs.append(
                np.asarray(
                    self.encoder.encode_batch(window_texts[s : s + bs]),
                    np.float32,
                )
            )
        chunk_emb = (
            np.concatenate(embs)
            if embs
            else np.zeros((0, cfg.embedding_dim), np.float32)
        )
        norms = np.linalg.norm(chunk_emb, axis=1, keepdims=True)
        chunk_emb = np.where(
            norms > 0, chunk_emb / np.maximum(norms, 1e-12), chunk_emb
        )

        payload = {
            "term_counts": term_counts,
            "chunk_emb": chunk_emb,
            "chunk_doc_local": np.asarray(chunk_doc_local, np.int32),
            "doc_n_chunks": np.asarray(doc_n_chunks, np.int32),
            "window_texts": window_texts,
            "doc_ids": [d.doc_id for d in docs],
            "urls": [d.url for d in docs],
            "titles": [d.title for d in docs],
            "snippets": [make_snippet(d.title, d.text) for d in docs],
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)
        return path

    # --- merge stage --------------------------------------------------------

    def merge(self, n_shards: int) -> IndexArtifacts:
        """Global stats reduction + impact computation over all shards.

        Delegates the CSR build to the same vectorized lexsort path as the
        one-shot builder (``builder.build_bm25_csr``) — global df/idf/avgdl
        can only be known here, so shards store raw (term, tf) counts and
        the merge computes impacts in one flattened pass.
        """
        cfg = self.cfg
        shards = []
        for i in range(n_shards):
            with open(self._shard_path(i), "rb") as f:
                shards.append(pickle.load(f))

        all_counts = [c for sh in shards for c in sh["term_counts"]]
        (indptr, post_docs, post_impact, idf, df, doc_len, avgdl), vocab = (
            build_bm25_csr(all_counts, cfg)
        )
        n_docs = len(all_counts)

        chunk_emb = np.concatenate([sh["chunk_emb"] for sh in shards])
        chunk_doc_parts = []
        doc_n_chunks = np.concatenate([sh["doc_n_chunks"] for sh in shards])
        off = 0
        for sh in shards:
            chunk_doc_parts.append(sh["chunk_doc_local"] + off)
            off += len(sh["doc_ids"])
        chunk_doc = np.concatenate(chunk_doc_parts).astype(np.int32)
        doc_chunk_start = np.zeros(n_docs, np.int32)
        np.cumsum(doc_n_chunks[:-1], out=doc_chunk_start[1:])

        def flat(key):
            out = []
            for sh in shards:
                out.extend(sh[key])
            return out

        urls = flat("urls")
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
            doc_n_chunks=doc_n_chunks.astype(np.int32),
            vocab=vocab,
            doc_ids=flat("doc_ids"),
            urls=urls,
            titles=flat("titles"),
            domains=[extract_domain(u) for u in urls],
            snippets=flat("snippets"),
            window_texts=flat("window_texts"),
            config=cfg,
            encoder_meta=getattr(
                self.encoder.encoder, "describe", dict
            )(),
        )

    # --- build --------------------------------------------------------------

    def build(self, documents: Iterable[Document]) -> IndexArtifacts:
        docs = list(documents)
        n_shards = max(1, -(-len(docs) // self.shard_size))
        for i in range(n_shards):
            self.build_shard(
                i, docs[i * self.shard_size : (i + 1) * self.shard_size]
            )
        manifest = {
            "n_shards": n_shards,
            "n_docs": len(docs),
            "shard_size": self.shard_size,
        }
        with open(os.path.join(self.out_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        return self.merge(n_shards)
