"""Operation and byte counts at a small shape, worked out by hand."""

from __future__ import annotations

import pytest

from benchmark import roofline

CFG = {"dim": 4, "mlp_ratio": 2, "n_layers": 1, "dtype": "bfloat16"}


def test_trunk_counts():
    # qkv 4x12 + proj 4x4 + wi 4x16 + wo 8x4
    assert roofline.matmul_params(CFG) == 48 + 16 + 64 + 32
    # 2 a weight a token, 3 tokens; QK^T and AV: 2 x 2 x 3 x 3 x 4
    assert roofline.trunk_flops(CFG, 3) == 2 * 160 * 3 + 4 * 9 * 4


def test_encoder_and_cross_encoder_work():
    flops, nbytes = roofline.encoder_work(CFG, [3, 2])
    assert flops == roofline.trunk_flops(CFG, 3) + roofline.trunk_flops(CFG, 2)
    assert nbytes == 160 * 2 + 5 * 4 * 2  # bf16 weights once, 5 token rows
    flops, nbytes = roofline.cross_work(CFG, [3])
    assert flops == roofline.trunk_flops(CFG, 3) + 2 * (16 + 4)
    assert nbytes == 160 * 2 + 20 * 4 + 3 * 4 * 2  # f32 head


def test_kernel_work():
    # 2 queries over 10 windows of dim 4 in bf16, 5 docs: the bank, the
    # queries, five [2, 5] outputs of 4 bytes
    assert roofline.dense_stats_work(2, 10, 5, 4, "bfloat16") == (
        2 * 2 * 10 * 4, 10 * 4 * 2 + 2 * 4 * 2 + 5 * 2 * 5 * 4)
    # 7 postings of 8 bytes, 2 queries x 4 slots x 8 bytes, a [2, 5] output
    assert roofline.bm25_work(7, 2, 4, 5) == (0.0, 56 + 64 + 40)


def test_least_time_takes_the_larger_bound():
    assert roofline.least_time(989e12, 0.0) == pytest.approx(1.0)
    assert roofline.least_time(0.0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_time(989e9, 3.35e12) == pytest.approx(1.0)


def test_batch_work_by_layer():
    shapes = {"n_docs": 5, "n_chunks": 10, "dim": 4, "bank_dtype": "bfloat16",
              "encoder": CFG, "cross_encoder": CFG}
    b = {"n": 2, "enc_tokens": [3, 2], "postings": 7, "T": 4,
         "ce_tokens": [3]}
    w = roofline.batch_work(b, shapes)
    assert set(w) == {"encoder", "bm25", "dense_stats", "stage3"}
    assert w["bm25"] == roofline.bm25_work(7, 2, 4, 5)


def test_token_count():
    assert roofline.token_count("w12 zabq zacq. zadq") == 5
