"""Deterministic hashing tokenizer for the on-device encoder.

The reference tokenizes with the SentenceTransformer's WordPiece tokenizer
(``indexer/indexer.py:106``, ``indexer/embedder.py:65``).  The TPU-native
encoder is self-contained (no downloaded vocab), so we use a feature-hashing
tokenizer: words are split by the same regex as the analyzer, each word maps
to ``hash64(word) % vocab_size`` with reserved special ids.  Per-token
character offsets are kept so sliding-window texts can be reconstructed
losslessly (see ``chunker.window_texts``).

Hashing is FNV-1a 64-bit — stable across processes and platforms (Python's
builtin ``hash`` is salted; never use it for index-persistent ids).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

_WORD_RE = re.compile(r"[a-zA-Z0-9äöüÄÖÜßàâéèêëíìîïóòôúùûñç]+|[^\sa-zA-Z0-9]")

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
UNK_ID = 3
N_SPECIAL = 4

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a_64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


class HashTokenizer:
    """Word-level hashing tokenizer with character offsets."""

    def __init__(
        self,
        vocab_size: int = 50257,
        cache_size: int = 1 << 18,
    ):
        if vocab_size <= N_SPECIAL:
            raise ValueError("vocab_size must exceed reserved special ids")
        self.vocab_size = vocab_size
        self._cache: dict = {}
        self._cache_size = cache_size

    def token_id(self, word: str) -> int:
        # natural-language word distributions are Zipfian: a small cache
        # absorbs almost all hashing work during corpus builds
        tid = self._cache.get(word)
        if tid is None:
            tid = N_SPECIAL + fnv1a_64(word.lower().encode("utf-8")) % (
                self.vocab_size - N_SPECIAL
            )
            if len(self._cache) < self._cache_size:
                self._cache[word] = tid
        return tid

    def encode_with_offsets(
        self, text: str
    ) -> Tuple[List[int], List[Tuple[int, int]]]:
        ids, offsets = [], []
        for m in _WORD_RE.finditer(text):
            ids.append(self.token_id(m.group(0)))
            offsets.append((m.start(), m.end()))
        return ids, offsets

    def encode(self, text: str) -> List[int]:
        return self.encode_with_offsets(text)[0]

    def pad_batch(
        self, batches: Sequence[Sequence[int]], max_len: int
    ) -> Tuple[List[List[int]], List[List[int]]]:
        """Pad/truncate to ``max_len`` with CLS/SEP framing; returns
        (ids, attention_mask)."""
        out_ids, out_mask = [], []
        body = max_len - 2
        for ids in batches:
            ids = list(ids)[:body]
            framed = [CLS_ID] + ids + [SEP_ID]
            mask = [1] * len(framed)
            pad = max_len - len(framed)
            out_ids.append(framed + [PAD_ID] * pad)
            out_mask.append(mask + [0] * pad)
        return out_ids, out_mask
