"""Encoder quality evaluation: trained bi-encoder vs hashing baseline.

The reference's dense stage quality comes from a fine-tuned bi-encoder
(``embedder_training/train.py:93-112`` fine-tunes ModernBERT on GooAQ pairs
and the report shows it beating lexical baselines).  This module provides
the air-gapped equivalent of that demonstration (VERDICT r1 #4):

  * a deterministic **semantic-gap corpus**: topics whose *query* vocabulary
    is disjoint from their *document* vocabulary (synonym structure).  A
    lexical-overlap encoder (``HashingEncoder``) cannot bridge the gap —
    query tokens hash to vectors orthogonal to every document token — so
    its retrieval quality is chance.  A trained bi-encoder learns the
    query-word -> topic -> doc-word alignment from (query, passage) pairs;
  * a retrieval evaluation (recall@k / NDCG@k / MRR over held-out queries
    and held-out documents) comparing any two ``encode_batch`` models;
  * a CLI that trains a checkpoint, runs the evaluation, and prints the
    metrics table (``python -m modern_search_engines_project_tpu_torch.eval.encoder_quality``).

The trained model must beat the hashing baseline decisively; the quick
version of this check runs in CI (tests/test_torch_train.py).

Counterpart of the reference package's ``eval/encoder_quality.py`` on the
port's trainer (``models/train.py``) and cross-encoder trainer: the same
corpus, metrics and defaults; training runs on ``device`` (the card
unless ``device="cpu"`` or ``--device cpu``).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

from modern_search_engines_project_tpu_torch.eval.metrics import ndcg_at_k, mrr


@dataclasses.dataclass
class SemanticCorpus:
    train_pairs: List[Tuple[str, str]]  # (query, passage)
    eval_docs: List[str]
    eval_doc_topics: List[int]
    eval_queries: List[str]
    eval_query_topics: List[int]
    n_topics: int


def semantic_corpus(
    n_topics: int = 16,
    n_train_pairs: int = 1200,
    docs_per_topic: int = 8,
    queries_per_topic: int = 3,
    seed: int = 0,
) -> SemanticCorpus:
    """Topics with disjoint query/document vocabularies (synonym gap)."""
    doc_vocab = {t: [f"art{t}x{k}" for k in range(6)] for t in range(n_topics)}
    qry_vocab = {t: [f"ask{t}y{k}" for k in range(3)] for t in range(n_topics)}
    filler = [f"fill{k}" for k in range(30)]

    def make_doc(t: int, r: random.Random) -> str:
        words = [r.choice(doc_vocab[t]) for _ in range(12)] + [
            r.choice(filler) for _ in range(6)
        ]
        r.shuffle(words)
        return " ".join(words)

    def make_query(t: int, r: random.Random) -> str:
        return " ".join(r.sample(qry_vocab[t], 2))

    r = random.Random(seed + 1)
    train_pairs = [
        (make_query(i % n_topics, r), make_doc(i % n_topics, r))
        for i in range(n_train_pairs)
    ]
    r2 = random.Random(seed + 99)  # held out: fresh docs AND fresh queries
    eval_docs, doc_topics = [], []
    for t in range(n_topics):
        for _ in range(docs_per_topic):
            eval_docs.append(make_doc(t, r2))
            doc_topics.append(t)
    eval_queries, query_topics = [], []
    for t in range(n_topics):
        for _ in range(queries_per_topic):
            eval_queries.append(make_query(t, r2))
            query_topics.append(t)
    return SemanticCorpus(
        train_pairs, eval_docs, doc_topics, eval_queries, query_topics, n_topics
    )


def dense_retrieval_metrics(
    encoder, corpus: SemanticCorpus, k: int = 10
) -> Dict[str, float]:
    """recall@k / NDCG@k / MRR of pure dense retrieval with ``encoder``."""
    D = np.asarray(encoder.encode_batch(corpus.eval_docs), np.float32)
    Q = np.asarray(encoder.encode_batch(corpus.eval_queries), np.float32)
    D /= np.maximum(np.linalg.norm(D, axis=1, keepdims=True), 1e-9)
    Q /= np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-9)
    sims = Q @ D.T
    doc_topics = np.asarray(corpus.eval_doc_topics)
    recs, ndcgs, mrrs = [], [], []
    for i, t in enumerate(corpus.eval_query_topics):
        order = np.argsort(-sims[i])
        rel = set(np.nonzero(doc_topics == t)[0].tolist())
        top = order[:k].tolist()
        recs.append(len(set(top) & rel) / min(k, len(rel)))
        ndcgs.append(ndcg_at_k(order.tolist(), {d: 1.0 for d in rel}, k))
        mrrs.append(mrr(order.tolist(), rel))
    return {
        f"recall@{k}": float(np.mean(recs)),
        f"ndcg@{k}": float(np.mean(ndcgs)),
        "mrr": float(np.mean(mrrs)),
    }


def random_negative_triples(
    pairs: Sequence[Tuple[str, str]], negatives: int = 1, seed: int = 7
) -> List[Tuple[str, str, float]]:
    """Positives + uniform random negatives (cheap alternative to mined
    negatives for the synthetic task; models/train.mine_hard_negatives is
    the production path)."""
    r = random.Random(seed)
    triples: List[Tuple[str, str, float]] = []
    for q, p in pairs:
        triples.append((q, p, 1.0))
        for _ in range(negatives):
            triples.append((q, pairs[r.randrange(len(pairs))][1], 0.0))
    return triples


def train_and_compare(
    n_topics: int = 16,
    n_train_pairs: int = 1200,
    dim: int = 64,
    n_layers: int = 2,
    vocab_size: int = 8192,
    max_len: int = 32,
    lr: float = 1e-3,
    epochs: int = 3,
    batch_size: int = 64,
    negatives: int = 2,
    k: int = 10,
    seed: int = 0,
    ckpt_out: str = "",
    device=None,
):
    """Train a bi-encoder on the semantic corpus and compare against the
    HashingEncoder baseline.  Returns (metrics_by_model, trained_encoder)."""
    from modern_search_engines_project_tpu_torch.models import HashingEncoder
    from modern_search_engines_project_tpu_torch.models.encoder import EncoderConfig
    from modern_search_engines_project_tpu_torch.models.train import (
        TrainConfig,
        Trainer,
    )

    corpus = semantic_corpus(n_topics, n_train_pairs, seed=seed)
    enc_cfg = EncoderConfig(
        vocab_size=vocab_size,
        dim=dim,
        n_layers=n_layers,
        n_heads=max(2, dim // 16),
        mlp_ratio=2,
        max_len=max_len,
    )
    tcfg = TrainConfig(
        learning_rate=lr, batch_size=batch_size, epochs=epochs, max_len=max_len
    )
    trainer = Trainer(enc_cfg, tcfg, device=device)
    triples = random_negative_triples(corpus.train_pairs, negatives, seed=7)
    losses = trainer.train(triples)
    trained = trainer.to_encoder()
    if ckpt_out:
        from modern_search_engines_project_tpu_torch.models.checkpoint import (
            save_encoder,
        )

        save_encoder(trainer.params, enc_cfg, ckpt_out)
        trained.ckpt_path = ckpt_out

    results = {
        "hashing": dense_retrieval_metrics(
            HashingEncoder(dim=dim, vocab_size=vocab_size), corpus, k
        ),
        "trained": dense_retrieval_metrics(trained, corpus, k),
    }
    results["trained"]["final_loss"] = losses[-1] if losses else float("nan")
    results["trained"]["steps"] = len(losses)
    return results, trained


def cross_encoder_mrr(reranker, corpus: SemanticCorpus, negatives: int = 8,
                      relevant: int = 2, seed: int = 0) -> float:
    """MRR of the first relevant candidate after joint rescoring: each
    held-out query gets ``relevant`` on-topic docs mixed with ``negatives``
    off-topic ones."""
    r = random.Random(seed)
    topics = np.asarray(corpus.eval_doc_topics)
    mrrs = []
    for q, t in zip(corpus.eval_queries, corpus.eval_query_topics):
        rel = [corpus.eval_docs[i] for i in np.nonzero(topics == t)[0][:relevant]]
        irr_pool = np.nonzero(topics != t)[0]
        cands = rel + [
            corpus.eval_docs[irr_pool[r.randrange(len(irr_pool))]]
            for _ in range(negatives)
        ]
        order = np.argsort(-reranker.rescore(q, cands))
        first_rel = int(np.nonzero(order < len(rel))[0].min()) + 1
        mrrs.append(1.0 / first_rel)
    return float(np.mean(mrrs))


def train_and_compare_cross_encoder(
    n_topics: int = 8,
    n_train_pairs: int = 600,
    dim: int = 64,
    vocab_size: int = 8192,
    max_len: int = 32,
    lr: float = 3e-3,
    epochs: int = 1,
    batch_size: int = 32,
    seed: int = 0,
    device=None,
):
    """Train the stage-3 cross-encoder on the semantic corpus and compare
    joint-rescoring MRR against an untrained one (the analog of the
    bi-encoder demonstration for the optional cross-encoder extension)."""
    from modern_search_engines_project_tpu_torch.models.cross_encoder import (
        CrossEncoderReranker,
        train_cross_encoder,
    )
    from modern_search_engines_project_tpu_torch.models.encoder import EncoderConfig

    corpus = semantic_corpus(n_topics, n_train_pairs, seed=seed)
    cfg = EncoderConfig(
        vocab_size=vocab_size,
        dim=dim,
        n_layers=1,
        n_heads=max(2, dim // 16),
        mlp_ratio=2,
        max_len=max_len,
    )
    triples = random_negative_triples(corpus.train_pairs, 1, seed=3)
    trained, losses = train_cross_encoder(
        triples, cfg, epochs=epochs, batch_size=batch_size,
        learning_rate=lr, max_len=max_len, device=device,
    )
    untrained = CrossEncoderReranker(cfg, max_len=max_len, seed=1,
                                     device=device)
    return {
        "untrained_mrr": cross_encoder_mrr(untrained, corpus),
        "trained_mrr": cross_encoder_mrr(trained, corpus),
        "final_loss": losses[-1] if losses else float("nan"),
        "steps": len(losses),
    }


def main(argv=None):
    import argparse
    import json
    import logging

    parser = argparse.ArgumentParser()
    parser.add_argument("--topics", type=int, default=16)
    parser.add_argument("--pairs", type=int, default=1200)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--ckpt-out", default="runs/encoder-demo")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    results, _ = train_and_compare(
        n_topics=args.topics,
        n_train_pairs=args.pairs,
        dim=args.dim,
        n_layers=args.layers,
        epochs=args.epochs,
        lr=args.lr,
        k=args.k,
        ckpt_out=args.ckpt_out,
        device=args.device,
    )
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
