"""Training-pair data loading (reference C18 data side,
embedder_training/train.py:40-92).

The reference fine-tunes on GooAQ (question, answer) pairs pulled from the
HuggingFace hub.  This environment (and many production ones) is
air-gapped, so the loader reads the same shape of data from local TSV
files — ``query\\tpassage`` per line — and synthesizes labeled triples via
hard-negative mining (models/train.py), mirroring the reference's
5-negatives "top"-sampled mining (train.py:48-60).

Also ships a deterministic synthetic pair generator so the training loop is
exercisable (tests, dry runs) with zero external data.

A copy of the reference package's ``models/data.py``; ``make_triples``
mines on the device ``mine_hard_negatives`` picks (``device``).
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

Pair = Tuple[str, str]
Triple = Tuple[str, str, float]


def load_pairs_tsv(path: str, limit: int = 0) -> List[Pair]:
    """query\\tpassage per line (GooAQ-style local dump)."""
    pairs: List[Pair] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t", 1)
            if len(parts) != 2:
                continue
            pairs.append((parts[0].strip(), parts[1].strip()))
            if limit and len(pairs) >= limit:
                break
    return pairs


def make_triples(
    pairs: Sequence[Pair],
    encoder,
    num_negatives: int = 5,
    device=None,
) -> List[Triple]:
    """pairs -> labeled triples with mined hard negatives
    (binary labels, train.py:69-92)."""
    from modern_search_engines_project_tpu_torch.models.train import (
        mine_hard_negatives,
    )

    queries = [q for q, _ in pairs]
    positives = [p for _, p in pairs]
    pool = list(dict.fromkeys(positives))
    return mine_hard_negatives(
        encoder, queries, positives, pool, k=num_negatives, device=device
    )


_TOPICS = [
    ("castle", "the old castle sits on the hill above the {} river"),
    ("library", "the {} library lends books and study spaces to students"),
    ("market", "fresh produce fills the {} market square every morning"),
    ("festival", "the {} festival brings music and food to the old town"),
    ("museum", "ancient artifacts are displayed in the {} museum halls"),
    ("bridge", "the stone bridge crosses the {} river near the mill"),
    ("university", "research and lectures define the {} university campus"),
    ("bakery", "the corner bakery in {} sells pretzels and dark bread"),
]
_PLACES = "neckar swabia alps harz rhine elbe danube mosel".split()


def synthetic_pairs(n: int, seed: int = 0) -> List[Pair]:
    """Deterministic topical (query, passage) pairs for offline training."""
    rng = random.Random(seed)
    pairs: List[Pair] = []
    for i in range(n):
        topic, template = _TOPICS[i % len(_TOPICS)]
        place = rng.choice(_PLACES)
        query = f"{topic} {place}"
        passage = template.format(place)
        pairs.append((query, passage))
    return pairs
