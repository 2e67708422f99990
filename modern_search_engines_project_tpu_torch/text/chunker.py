"""Sliding-window chunking over token ids.

Re-implements the reference's window semantics exactly
(``indexer/embedder.py:65-87``): fixed windows of ``window_size`` tokens
starting every ``step_size`` tokens, plus one extra *tail* window covering
the final ``window_size`` tokens whenever the last full window does not end
exactly at the sequence end.  Document shorter than one window -> a single
(short) window.

Windows are returned as (start, end) index pairs so the caller can slice
either token ids (for the on-device encoder) or character offsets (for
lossless window-text reconstruction — the reference instead decodes token
ids back to text, ``embedder.py:89-96``, which is lossy for us because the
TPU path uses a hashing tokenizer).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def sliding_window_bounds(
    n_tokens: int, window_size: int = 512, step_size: int = 450
) -> List[Tuple[int, int]]:
    """(start, end) half-open bounds per window; parity with embedder.py:65-87."""
    if n_tokens <= 0:
        return []
    if n_tokens <= window_size:
        return [(0, n_tokens)]
    bounds = []
    start = 0
    while start + window_size <= n_tokens:
        bounds.append((start, start + window_size))
        start += step_size
    # tail window when the last full window doesn't land on the end
    if bounds[-1][1] != n_tokens:
        bounds.append((n_tokens - window_size, n_tokens))
    return bounds


def create_sliding_windows(
    token_ids: Sequence[int], window_size: int = 512, step_size: int = 450
) -> List[List[int]]:
    """Windows of token ids (reference ``create_sliding_windows`` analog)."""
    ids = list(token_ids)
    return [
        ids[s:e] for s, e in sliding_window_bounds(len(ids), window_size, step_size)
    ]


def window_texts(
    text: str,
    offsets: Sequence[Tuple[int, int]],
    window_size: int = 512,
    step_size: int = 450,
) -> List[str]:
    """Reconstruct window texts from per-token character offsets.

    ``offsets[i] = (char_start, char_end)`` of token i in ``text``.  The
    window's text is the original substring spanning its first token's start
    to its last token's end — lossless, unlike token-id decode.
    """
    out = []
    for s, e in sliding_window_bounds(len(offsets), window_size, step_size):
        c0 = offsets[s][0]
        c1 = offsets[e - 1][1]
        out.append(text[c0:c1])
    return out
