"""The query model of the bench corpus, drawn from the seed in bulk.

A query is ``min_terms``-``max_terms`` terms drawn with replacement by
document frequency from every term but the anchor (preprocessing appends
the anchor to every query), written as words in term order, a repeated
term repeated.  Queries of one run are distinct strings, so no cache
answers one from an earlier one.  Open-loop arrivals follow one sequence
of Poisson gaps for every seed, entered at a point the seed draws, so
every seed offers the same work and the same bursts in another order:
with a few hundred requests in a window, fresh Poisson draws move a tail
by a third from seed to seed.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _sampler(seed: int, dfs: np.ndarray, stream: int):
    return (np.random.default_rng([int(seed), stream]),
            np.cumsum(dfs[1:] / dfs[1:].sum()))


def _block(rng, cdf, words: List[str], model: dict, m: int) -> List[str]:
    """``m`` query strings of ``model``, repeats possible."""
    n_q = rng.integers(model["min_terms"], model["max_terms"] + 1, m)
    ids = 1 + np.minimum(np.searchsorted(cdf, rng.random(int(n_q.sum()))),
                         len(cdf) - 1)
    ends = np.cumsum(n_q)
    return [" ".join(words[t] for t in np.sort(row).tolist())
            for row in np.split(ids, ends[:-1])]


def draw_queries(seed: int, words: List[str], dfs: np.ndarray, n: int,
                 model: dict, stream: int = 2) -> List[str]:
    """``n`` distinct query strings of ``model`` (``min_terms``,
    ``max_terms``) from ``seed``; ``stream`` keeps warm-up and timed
    queries apart."""
    rng, cdf = _sampler(seed, dfs, stream)
    out: dict = {}
    while len(out) < n:
        for q in _block(rng, cdf, words, model, (n - len(out)) * 5 // 4 + 64):
            out.setdefault(q, None)
            if len(out) == n:
                break
    return list(out)


class QueryStream:
    """Distinct query strings of ``model`` from ``seed``, drawn in blocks
    as they are asked for, so no guess of a rate bounds how many a closed
    loop can send; ``exclude`` never comes."""

    BLOCK = 1024

    def __init__(self, seed: int, words: List[str], dfs, model: dict,
                 stream: int = 2, exclude=()):
        self.rng, self.cdf = _sampler(seed, np.asarray(dfs, np.float64), stream)
        self.words, self.model = words, model
        self.seen = set(exclude)
        self.ready: List[str] = []

    def next(self) -> str:
        while not self.ready:
            for q in _block(self.rng, self.cdf, self.words, self.model,
                            self.BLOCK):
                if q not in self.seen:
                    self.seen.add(q)
                    self.ready.append(q)
            self.ready.reverse()
        return self.ready.pop()


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Open-loop send times (s from the window's start), ascending: one
    sequence of Poisson gaps of ``rate``, drawn once and the same for every
    seed, started at a point the seed draws and wrapped round, scaled to
    put ``rate`` x ``seconds`` arrivals in the window."""
    n = int(round(rate * seconds))
    gaps = np.random.default_rng(0).exponential(1.0, n + 1)
    gaps = np.roll(gaps, -int(np.random.default_rng([int(seed), 3]).integers(n + 1)))
    return np.cumsum(gaps)[:n] / gaps.sum() * seconds
