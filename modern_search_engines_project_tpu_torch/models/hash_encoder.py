"""Deterministic random-projection bag-of-words encoder.

A self-contained stand-in for the reference's downloaded SentenceTransformer
(``as-bessonov/reranker_searchengines_cos2``, reference ``config.py:1``):
each hashed token id maps to a fixed pseudo-random unit vector; a text's
embedding is the L2-normalized sum.  Deterministic across processes (vectors
are generated per-id from a counter-based hash, not a stateful RNG), so
index-time and query-time embeddings always agree.

This gives real lexical-overlap cosine structure for tests/benchmarks, and
implements the same ``encode_batch`` protocol as the trained JAX bi-encoder
(``models/encoder.py``) so the two are interchangeable in the build pipeline
and the serving engine.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from modern_search_engines_project_tpu_torch.text.hash_tokenizer import HashTokenizer


class HashingEncoder:
    """encode_batch(texts) -> float32 [n, dim] L2-normalized embeddings."""

    def __init__(self, dim: int = 768, vocab_size: int = 50257, seed: int = 0):
        self.dim = dim
        self.vocab_size = vocab_size
        self.seed = seed
        self.tokenizer = HashTokenizer(vocab_size)

    def describe(self) -> dict:
        """Provenance record stored in index artifacts so serving can refuse
        to pair an index with a mismatched query encoder (ADVICE r1)."""
        return {
            "kind": "hashing",
            "dim": self.dim,
            "vocab_size": self.vocab_size,
            "seed": self.seed,
        }

    def _token_vec(self, token_ids: np.ndarray) -> np.ndarray:
        """Pseudo-random unit vectors per token id, counter-based (stateless)."""
        # Philox-style determinism via per-id seeded Generator streams would be
        # slow per token; instead derive a [n_ids, dim] matrix from a hashed
        # counter sequence in one vectorized pass.
        idx = token_ids.astype(np.uint64)
        cols = np.arange(self.dim, dtype=np.uint64)
        # splitmix64-inspired mixing of (token_id, col, seed)
        x = idx[:, None] * np.uint64(0x9E3779B97F4A7C15)
        x = x + cols[None, :] * np.uint64(0xBF58476D1CE4E5B9) + np.uint64(self.seed)
        x ^= x >> np.uint64(30)
        x = x * np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
        # map to float in [-1, 1)
        vals = (x >> np.uint64(11)).astype(np.float64) / float(1 << 53) * 2.0 - 1.0
        return vals.astype(np.float32)

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        """One vectorized pass over the whole batch.

        Zipf dedup is the trick: duplicate (text, token) pairs collapse to
        counts, and token vectors are generated once per DISTINCT token id
        in the batch — for corpus builds this cuts _token_vec work ~10x
        (the python per-text loop was the host build bottleneck after the
        native tokenizer landed).
        """
        ids_list = [
            np.asarray(self.tokenizer.encode(t), dtype=np.int64) for t in texts
        ]
        return self.encode_id_batch(ids_list)

    def encode_id_batch(self, ids_list: Sequence[np.ndarray]) -> np.ndarray:
        """encode_batch over pre-tokenized id arrays.  The index builder
        already tokenized each document once to cut its windows — the text
        round-trip (decode span -> re-tokenize) was ~40% of dense build
        time at corpus shapes, and re-tokenizing a window span reproduces
        exactly these ids (spans start/end on token boundaries)."""
        n = len(ids_list)
        out = np.zeros((n, self.dim), dtype=np.float32)
        lens = np.array([x.size for x in ids_list], dtype=np.int64)
        if lens.sum() == 0:
            out[:, 0] = 1.0
            return out
        flat = np.concatenate([x for x in ids_list if x.size])
        row = np.repeat(np.arange(n, dtype=np.int64), lens)
        # collapse duplicate (row, id) pairs to counts
        key = row * self.vocab_size + flat
        ukey, counts = np.unique(key, return_counts=True)
        urow = ukey // self.vocab_size
        uid = ukey % self.vocab_size
        # one vector per distinct token id in the batch
        uids, vinv = np.unique(uid, return_inverse=True)
        vecs = self._token_vec(uids)
        if n * uids.size <= 64_000_000:
            # bag-of-words as a GEMM: counts [n, n_unique] @ vecs — one BLAS
            # call instead of a segment reduction
            cmat = np.zeros((n, uids.size), np.float32)
            cmat[urow, vinv] = counts  # (row, id) pairs are unique
            out[:] = cmat @ vecs
        else:  # huge batch x vocab: stay memory-bounded
            contrib = vecs[vinv] * counts[:, None].astype(np.float32)
            bounds = np.nonzero(np.diff(urow, prepend=-1))[0]
            out[urow[bounds]] = np.add.reduceat(contrib, bounds, axis=0)
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        np.divide(out, norms, out=out, where=norms > 0)
        out[(norms[:, 0] == 0), 0] = 1.0  # empty/zero texts: unit e0
        return out

    def encode(self, text: str) -> np.ndarray:
        return self.encode_batch([text])[0]
