"""Decodable word vocabulary for the generative summarizer.

The retrieval stack hashes words to ids (``text/hash_tokenizer.py``) —
one-way by design, which is fine for similarity but useless for
GENERATION.  The summary decoder needs to emit words, so it carries its
own frozen id<->word table built from the training corpus (most-frequent
words first; everything else maps to <unk>).  This mirrors how the
reference delegates generation to an external LLM with its own vocab
(``search_assistant/main.py:57-65``) — here the vocab is local and
air-gapped.

A copy of the reference package's ``models/word_vocab.py`` (pure Python;
the port keeps its own copy so that it imports nothing of that package).
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Iterable, List, Sequence

_WORD_RE = re.compile(r"[a-z0-9äöüß]+|[^\sa-z0-9äöüß]")

PAD_ID = 0
BOS_ID = 1
SEP_ID = 2
EOS_ID = 3
UNK_ID = 4
N_SPECIAL = 5
_SPECIAL_TOKENS = ["<pad>", "<bos>", "<sep>", "<eos>", "<unk>"]


class WordVocab:
    """Frozen most-frequent-first word table with specials."""

    def __init__(self, words: Sequence[str]):
        self.words: List[str] = _SPECIAL_TOKENS + list(words)
        self.index = {w: i for i, w in enumerate(self.words)}

    def __len__(self) -> int:
        return len(self.words)

    @classmethod
    def build(cls, texts: Iterable[str], max_words: int = 32000) -> "WordVocab":
        counts: Counter = Counter()
        for t in texts:
            counts.update(_WORD_RE.findall(t.lower()))
        top = [w for w, _ in counts.most_common(max_words - N_SPECIAL)]
        return cls(top)

    def encode(self, text: str) -> List[int]:
        return [
            self.index.get(w, UNK_ID) for w in _WORD_RE.findall(text.lower())
        ]

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i == EOS_ID:
                break
            if i < N_SPECIAL:
                continue
            if i < len(self.words):
                out.append(self.words[i])
        # re-attach punctuation the word regex split off
        text = ""
        for w in out:
            if text and (w.isalnum() or w in "([{\"'"):
                text += " "
            text += w
        return text

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.words[N_SPECIAL:], f, ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "WordVocab":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))
