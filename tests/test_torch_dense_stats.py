"""Plain version of the dense-stats kernel against the reference's Pallas
kernel (interpret mode) and its XLA formulation, in f32 with
rtol = atol = 1e-5 (the same sims summed in another order), including
single-chunk buckets and exact ties between slots."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modern_search_engines_project_tpu.retrieval import ops as ref_ops
from modern_search_engines_project_tpu.retrieval.dense_pallas import (
    bucket_stats_pallas,
)
from modern_search_engines_project_tpu_torch.retrieval import dense_stats

BUCKETS = [(1, 16), (2, 8), (3, 24), (5, 8), (10, 128)]
NAMES = ("v1", "v2", "w1", "w2", "vmin")


def _bucket(n, cnt, dim=64, B=8, seed=5):
    rng = np.random.default_rng(seed + 10 * n + cnt)
    q = rng.standard_normal((B, dim)).astype(np.float32)
    e = rng.standard_normal((n, cnt, dim)).astype(np.float32)
    if n > 1:
        e[1, :4] = e[0, :4]  # exact ties between slots 0 and 1
    if n > 3:
        e[3, 4:6] = e[2, 4:6]
    return q, e


def _assert_stats(got, want, tol=1e-5):
    for a, b, name in zip(got, want, NAMES):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=tol, atol=tol, err_msg=name
        )


@pytest.mark.parametrize(
    "n,cnt,B",
    [(n, cnt, 8) for n, cnt in BUCKETS]
    + [(10, 200, 1), (10, 77, 17), (3, 300, 65), (10, 130, 65)],
)
def test_plain_matches_pallas_kernel(n, cnt, B):
    """Also at the CUDA kernel's edges: cnt not a multiple of 128, n = 10,
    and B = 1 / 17 / 65 (one query tile of 8, one past 16, one past 64)."""
    q, e = _bucket(n, cnt, B=B)
    want = bucket_stats_pallas(jnp.asarray(e), jnp.asarray(q), interpret=True)
    got = dense_stats.stats_plain(torch.as_tensor(e), torch.as_tensor(q))
    _assert_stats([x.numpy() for x in got], want)


@pytest.mark.parametrize("n,cnt", BUCKETS)
def test_plain_matches_xla_formulation(n, cnt):
    q, e = _bucket(n, cnt)
    (want,) = ref_ops.bucket_doc_stats(
        ((n, cnt),), (jnp.asarray(e),), (jnp.ones(cnt, bool),),
        jnp.asarray(q),
    )
    got = dense_stats.stats_plain(torch.as_tensor(e), torch.as_tensor(q))
    _assert_stats([x.numpy() for x in got], want)


def test_bf16_bank_matches_reference():
    """A bf16 bank: the query is cast to the bank dtype, products summed in
    f32 — as the reference does."""
    q, e = _bucket(4, 32, dim=96)
    e_bf = jnp.asarray(e, jnp.bfloat16)
    (want,) = ref_ops.bucket_doc_stats(
        ((4, 32),), (e_bf,), (jnp.ones(32, bool),), jnp.asarray(q)
    )
    emb = torch.as_tensor(np.asarray(e_bf, np.float32)).to(torch.bfloat16)
    got = dense_stats.stats_plain(emb, torch.as_tensor(q))
    _assert_stats([x.numpy() for x in got], want)


def test_single_chunk_contract():
    q, e = _bucket(1, 8)
    v1, v2, w1, w2, vm = dense_stats.stats_plain(
        torch.as_tensor(e), torch.as_tensor(q)
    )
    assert torch.equal(v1, v2) and torch.equal(v1, vm)
    assert (w1 == 0).all() and (w2 == 0).all()


def test_tie_keeps_lowest_slot():
    """Equal sims: v1 takes the lowest slot, the duplicate lands in v2."""
    q, e = _bucket(3, 8)
    e[2] = e[0]
    e[1] = -e[0]
    emb, qv = torch.as_tensor(e), torch.as_tensor(q)
    v1, v2, w1, w2, _ = dense_stats.stats_plain(emb, qv)
    pos = dense_stats.bucket_sims(emb, qv)[:, 0] > 0  # slots 0 and 2 win
    assert pos.any() and (~pos).any()
    assert (w1[pos] == 0).all() and (w2[pos] == 2).all()
    assert torch.equal(v1[pos], v2[pos])


def test_wrapper_takes_plain_version_on_cpu():
    q, e = _bucket(3, 24)
    before = dense_stats.STATS_KERNEL.launches
    got = dense_stats.bucket_stats(torch.as_tensor(e), torch.as_tensor(q))
    want = dense_stats.stats_plain(torch.as_tensor(e), torch.as_tensor(q))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert dense_stats.STATS_KERNEL.launches == before


def test_error_measure_counts_slots_by_value():
    """Swapped slots of two equal sims are no error; a wrong value is."""
    q, e = _bucket(3, 24)
    emb, qv = torch.as_tensor(e), torch.as_tensor(q)
    want = dense_stats.stats_plain(emb, qv)
    sims = dense_stats.bucket_sims(emb, qv)
    v1, v2, w1, w2, vm = want
    tied = torch.isclose(v1, v2, rtol=0, atol=0)
    assert tied.any()  # the forced ties of slots 0 and 1
    swapped = (v1, v2, torch.where(tied, w2, w1), torch.where(tied, w1, w2), vm)
    assert dense_stats.stats_max_abs_err(swapped, want, sims) == 0.0
    bad = (v1 + 0.5, v2, w1, w2, vm)
    assert dense_stats.stats_max_abs_err(bad, want, sims) >= 0.5
