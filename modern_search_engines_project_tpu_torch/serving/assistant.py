"""Search assistant: LLM-style summary over the top result windows.

Counterpart of the reference package's ``serving/assistant.py``.
Reference C9 (``search_assistant/main.py``) is a FastAPI sidecar calling
the external Cerebras API (qwen-3-235b) with the top <= 10 windows truncated
to 4000 chars each.  Here the assistant is an in-process component with a
pluggable backend:

  * ``ExtractiveSummarizer`` (default) — deterministic, fully offline:
    ranks sentences from the windows by query-term overlap and stitches a
    short grounded summary.  No network, no model weights.
  * ``HttpLlmClient`` — POSTs the reference's exact request schema
    ``{most_relevant_windows, query}`` to any compatible endpoint
    (search_assistant/main.py:35-76), for deployments that do run an
    external LLM, through ``urllib.request`` (no third-party client).
    Strips a leading ``</think>`` reasoning prefix like the reference
    (main.py:69-71).
  * ``GenerativeSummarizer`` — the causal decoder on the card
    (``models/decoder.py``) trained on mined (window -> summary head)
    pairs from the real corpus: abstractive summaries with zero external
    dependencies.  Load with ``from_checkpoint``.  Its extractive
    fallback answers degenerate decodes (the reference's own rule); an
    error on the device is raised, never answered by the fallback.
"""

from __future__ import annotations

import json
import re
import urllib.request
from typing import List, Protocol, Sequence

from modern_search_engines_project_tpu_torch.models.decoder import (
    DecoderLM,
    GreedyGenerator,
    load_decoder,
)
from modern_search_engines_project_tpu_torch.models.word_vocab import (
    BOS_ID,
    SEP_ID,
    WordVocab,
)

MAX_WINDOWS = 10  # config.py:22
WINDOW_CHARS = 4000  # search_assistant/main.py:47


class Summarizer(Protocol):
    def generate_summary(self, query: str, windows: Sequence[str]) -> str: ...


_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_WORD_RE = re.compile(r"[a-zA-Zäöüß]+")


class ExtractiveSummarizer:
    """Query-focused extractive summary (offline default backend)."""

    def __init__(self, max_sentences: int = 4, max_chars: int = 700):
        self.max_sentences = max_sentences
        self.max_chars = max_chars

    def generate_summary(self, query: str, windows: Sequence[str]) -> str:
        windows = [w[:WINDOW_CHARS] for w in windows[:MAX_WINDOWS] if w]
        if not windows:
            return ""
        q_terms = {w.lower() for w in _WORD_RE.findall(query) if len(w) > 2}
        scored = []
        seen = set()
        for wi, window in enumerate(windows):
            for sent in _SENT_RE.split(window):
                sent = sent.strip()
                if len(sent) < 30 or len(sent) > 400:
                    continue
                key = sent.lower()[:80]
                if key in seen:
                    continue
                seen.add(key)
                words = {w.lower() for w in _WORD_RE.findall(sent)}
                overlap = len(words & q_terms)
                # earlier windows come from higher-ranked documents
                scored.append((overlap - 0.1 * wi, sent, words))
        scored.sort(key=lambda x: -x[0])
        # greedy pick with a redundancy gate: overlapping windows repeat
        # near-identical sentences under different prefixes, which the
        # exact-key dedup above cannot catch
        picked, picked_words = [], []
        for score, sent, words in scored:
            if score <= 0 and picked:
                break
            if any(
                len(words & pw) > 0.7 * max(1, min(len(words), len(pw)))
                for pw in picked_words
            ):
                continue
            picked.append(sent)
            picked_words.append(words)
            if len(picked) >= self.max_sentences:
                break
        if not picked and scored:
            picked = [scored[0][1]]
        out = " ".join(picked)
        return out[: self.max_chars]


class GenerativeSummarizer:
    """On-device abstractive summary: greedy decode from the trained
    summary LM, prompted with the query and the top window texts.

    The prompt mirrors training rows (tools/real_summarizer.py):
    ``[BOS] query-words <sep> window-words... <sep>`` and the model
    emits summary words until EOS.  Falls back to the extractive
    backend when the decode comes back empty/degenerate, so the serving
    contract (non-empty ``llm_response`` whenever windows exist) holds
    from the first checkpoint onward.

    ``device``: "cuda" (default) or "cpu"; with no card and no
    ``device="cpu"`` this raises."""

    def __init__(self, model: DecoderLM, vocab: WordVocab, max_new: int = 48,
                 device=None):
        self.gen = GreedyGenerator(model, device)
        self.vocab = vocab
        self.cfg = model.cfg
        self.max_new = max_new
        self._fallback = ExtractiveSummarizer()

    @classmethod
    def from_checkpoint(cls, path: str, device=None,
                        **kw) -> "GenerativeSummarizer":
        model, _, vocab = load_decoder(path, device)
        if vocab is None:
            raise ValueError(f"{path} has no vocab.json (generation vocab)")
        return cls(model, vocab, device=device, **kw)

    def prompt_ids(self, query: str, windows: Sequence[str]) -> List[int]:
        """``[BOS] query-words <sep> window-words... <sep>`` within the
        budget that leaves ``max_new`` positions to the decode; ``windows``
        as ``generate_summary`` passes them (cut, non-empty)."""
        budget = self.cfg.max_len - self.max_new - 3
        q_ids = self.vocab.encode(query)[:24]
        ids = [BOS_ID] + q_ids + [SEP_ID]
        for w in windows:
            if len(ids) >= budget:
                break
            ids += self.vocab.encode(w)[: budget - len(ids)]
        return ids[:budget] + [SEP_ID]

    def generate_summary(self, query: str, windows: Sequence[str]) -> str:
        windows = [w[:WINDOW_CHARS] for w in windows[:MAX_WINDOWS] if w]
        if not windows:
            return ""
        toks = self.gen.generate([self.prompt_ids(query, windows)],
                                 max_new=self.max_new)[0]
        text = self.vocab.decode(toks).strip()
        # degenerate decodes fall back to the extractive backend: too
        # short, low vocabulary, or greedy bigram looping ("a file to a
        # file") — a small greedy LM's classic failure mode on inputs
        # far from its training distribution
        words = text.split()
        bigrams = list(zip(words, words[1:]))
        looping = bigrams and len(set(bigrams)) <= 0.75 * len(bigrams)
        if (
            len(words) < 4
            or len(set(words)) < max(2, len(words) // 4)
            or looping
        ):
            return self._fallback.generate_summary(query, windows)
        return text


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    """Leave a 3xx answer as it came, an error like any non-2xx one."""

    def redirect_request(self, req, fp, code, msg, headers, newurl):
        return None


class HttpLlmClient:
    """Client for a reference-compatible /generate_summary endpoint."""

    def __init__(self, url: str, timeout: float = 30.0):
        self.url = url
        self.timeout = timeout

    def generate_summary(self, query: str, windows: Sequence[str]) -> str:
        payload = {
            "most_relevant_windows": [
                w[:WINDOW_CHARS] for w in windows[:MAX_WINDOWS]
            ],
            "query": query,
        }
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        # urllib raises HTTPError on a 4xx or 5xx answer, and on a 3xx one
        # when it follows no redirect
        opener = urllib.request.build_opener(_NoRedirect)
        with opener.open(req, timeout=self.timeout) as resp:
            if not 200 <= resp.status < 300:
                raise OSError(f"{self.url}: HTTP {resp.status}")
            text = json.loads(resp.read()).get("response", "")
        # strip reasoning prefix (search_assistant/main.py:69-71)
        if "</think>" in text:
            text = text.split("</think>", 1)[1].strip()
        return text
