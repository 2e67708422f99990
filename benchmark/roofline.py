"""Peaks of the card and the work a batch's inputs need, counted from shapes.

Nothing here reads the program's own counts.  Bytes count each input once
and each output once, whatever a kernel reads again; operations count the
products the inputs need (two a multiply-add), not the padding a program
adds.  A batch's least time is the larger of its operations at the bf16
peak and its bytes at the memory peak.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

_TOKEN = re.compile(r"[a-zA-Z0-9äöüÄÖÜßàâéèêëíìîïóòôúùûñç]+|[^\sa-zA-Z0-9]")


def dtype_bytes(name: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}[name]


def matmul_params(cfg: dict) -> int:
    """Weights of a trunk's products (the token table is gathered)."""
    D, H = cfg["dim"], cfg["dim"] * cfg["mlp_ratio"]
    return cfg["n_layers"] * (D * 3 * D + D * D + D * 2 * H + H * D)


def trunk_flops(cfg: dict, n_tokens: int) -> float:
    """One sequence of ``n_tokens`` through a trunk: the weight products
    and the two attention products."""
    return (2.0 * matmul_params(cfg) * n_tokens
            + 4.0 * n_tokens * n_tokens * cfg["dim"] * cfg["n_layers"])


def encoder_work(cfg: dict, tokens: Iterable[int]):
    """(flops, bytes) of the bi-encoder over sequences of ``tokens``
    tokens each (the CLS/SEP framing counted)."""
    tokens = list(tokens)
    w = dtype_bytes(cfg["dtype"])
    flops = sum(trunk_flops(cfg, n) for n in tokens)
    nbytes = matmul_params(cfg) * w + sum(tokens) * cfg["dim"] * w
    return flops, nbytes


def cross_work(cfg: dict, tokens: Iterable[int]):
    """(flops, bytes) of the cross-encoder and its head over pairs of
    ``tokens`` tokens each."""
    tokens = list(tokens)
    D = cfg["dim"]
    flops = sum(trunk_flops(cfg, n) + 2.0 * (D * D + D) for n in tokens)
    w = dtype_bytes(cfg["dtype"])
    nbytes = (matmul_params(cfg) * w + (D * D + D) * 4
              + sum(tokens) * D * w)
    return flops, nbytes


def dense_stats_work(n_queries: int, n_chunks: int, n_docs: int, dim: int,
                     bank_dtype: str):
    """Kernel 4 over the whole bank: each window read once, the queries,
    and five [query, doc] outputs of 4 bytes."""
    w = dtype_bytes(bank_dtype)
    flops = 2.0 * n_queries * n_chunks * dim
    nbytes = (n_chunks * dim * w + n_queries * dim * w
              + 5 * n_queries * n_docs * 4)
    return flops, nbytes


def bm25_work(postings: int, n_queries: int, n_terms: int, n_docs: int):
    """The BM25 kernels: each distinct term's postings of the batch once
    (4-byte doc id and 4-byte impact), the query arrays (a 4-byte id and
    weight a term slot), the keyed [query, doc] output of 4 bytes."""
    return (0.0, 8.0 * postings + 8.0 * n_queries * n_terms
            + 4.0 * n_queries * n_docs)


def least_time(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def batch_work(batch: Dict, shapes: Dict) -> Dict[str, tuple]:
    """(flops, bytes) by layer of one traced batch (see ``trace.Spans``)."""
    n = batch["n"]
    out = {}
    if "enc_tokens" in batch:
        out["encoder"] = encoder_work(shapes["encoder"], batch["enc_tokens"])
    if "postings" in batch:
        out["bm25"] = bm25_work(batch["postings"], n, batch["T"],
                                shapes["n_docs"])
        out["dense_stats"] = dense_stats_work(
            n, shapes["n_chunks"], shapes["n_docs"], shapes["dim"],
            shapes["bank_dtype"])
    if batch.get("ce_tokens"):
        out["stage3"] = cross_work(shapes["cross_encoder"], batch["ce_tokens"])
    return out


def token_count(text: str) -> int:
    """Tokens of the encoders' word-level tokenizer in ``text``."""
    return len(_TOKEN.findall(text))
