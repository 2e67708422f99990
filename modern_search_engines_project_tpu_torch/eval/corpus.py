"""Synthetic corpus generator (the load test's documents).

Zipfian word distribution over a few hundred distinct words so document
frequencies span the realistic range (a few ubiquitous terms with negative
idf, a long tail of rare informative terms) — uniform draws from a tiny
pool make every idf negative and empty every result list.

A copy of the generator in the repository's ``tests/corpus_util.py``,
which the reference package's load test imports: the same seed gives the
same documents.
"""

import random

from modern_search_engines_project_tpu_torch.index.builder import Document

_BASE = (
    "castle river neckar museum university student market church tower bridge "
    "library garden forest hill chocolate festival boat punt cafe bakery "
    "physics biology informatics hospital cathedral history art gallery "
    "mountain valley street square station train city tour walk guide old "
    "town hall cyber ai neuro research institute law faculty"
).split()


def _letters(n: int) -> str:
    """Base-26 letter suffix (tokenizer-safe: no digits)."""
    s = ""
    n += 1
    while n:
        n, r = divmod(n - 1, 26)
        s = chr(ord("a") + r) + s
    return s


def make_vocab(n_words: int = 400):
    vocab = list(_BASE)
    i = 0
    while len(vocab) < n_words:
        vocab.append(f"{_BASE[i % len(_BASE)]}{_letters(i // len(_BASE))}q")
        i += 1
    return vocab


def zipf_words(rng: random.Random, vocab, n: int):
    out = []
    V = len(vocab)
    for _ in range(n):
        # inverse-CDF Zipf-ish: rank ~ floor(V^u) biases toward low ranks
        r = int(V ** rng.random()) - 1
        out.append(vocab[max(0, min(r, V - 1))])
    return out


def make_corpus(
    n_docs: int = 80,
    seed: int = 42,
    n_words: int = 400,
    min_len: int = 20,
    max_len: int = 300,
    n_domains: int = 16,
    tuebingen_frac: float = 0.7,
    base_id: int = 1000,
):
    rng = random.Random(seed)
    vocab = make_vocab(n_words)
    docs = []
    for i in range(n_docs):
        n = rng.randint(min_len, max_len)
        words = zipf_words(rng, vocab, n)
        if rng.random() < tuebingen_frac:
            words.insert(rng.randrange(len(words)), "tübingen")
        domain = f"www.site{rng.randint(0, n_domains - 1)}.de"
        docs.append(
            Document(
                doc_id=base_id + i,
                url=f"https://{domain}/page{i}",
                title=f"{rng.choice(vocab)} page {i}",
                text=" ".join(words),
            )
        )
    return docs
