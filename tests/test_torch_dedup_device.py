"""The port's ``dedup_query_terms_device`` (``retrieval/bm25_slots.py``)
against the reference's (``retrieval/bm25_pallas.py``, jitted on the CPU)
and against the port's host ``dedup_query_terms``, on batches made with
numpy from fixed seeds.  Integer ids and qtf: every output must be equal,
bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modern_search_engines_project_tpu.retrieval.bm25_pallas import (
    dedup_query_terms_device as ref_dedup,
)
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    bm25_score_slots_udedup,
    dedup_query_terms,
    dedup_query_terms_device,
    u_pad_for,
)

_ref = jax.jit(ref_dedup, static_argnums=2)


def batch(case, seed):
    """(term ids [B, T] int32, qtf [B, T] f32, u_pad) of one case."""
    rng = np.random.default_rng(seed)
    B, T = 6, 8
    if case == "duplicates":  # the same id twice or more in one query
        t = rng.integers(0, 30, (B, T)).astype(np.int32)
        t[:, 1] = t[:, 0]
        t[2, :] = 7
    elif case == "pads":
        t = rng.integers(0, 5000, (B, T)).astype(np.int32)
        t[rng.random((B, T)) < 0.4] = -1
    elif case == "all_pads":
        t = np.full((B, T), -1, np.int32)
    elif case == "distinct_equals_u_pad":
        t = rng.permutation(np.arange(100, 100 + B * T)).reshape(B, T)
        t = t.astype(np.int32)
    else:  # "distinct_above_u_pad": the drop rule
        t = rng.integers(0, 10_000, (B, T)).astype(np.int32)
        t[0, :3] = -1
    q = np.where(t >= 0, rng.integers(1, 5, (B, T)), 0).astype(np.float32)
    n = np.unique(t[t >= 0]).size
    u_pad = {"distinct_equals_u_pad": B * T,
             "distinct_above_u_pad": max(1, n // 3)}.get(case, u_pad_for(n))
    return t, q, u_pad


CASES = ["duplicates", "pads", "all_pads", "distinct_equals_u_pad",
         "distinct_above_u_pad"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", CASES)
def test_device_dedup_matches_reference(case, seed):
    t, q, u_pad = batch(case, seed)
    uids, w = dedup_query_terms_device(torch.from_numpy(t),
                                       torch.from_numpy(q), u_pad)
    want_u, want_w = _ref(jnp.asarray(t), jnp.asarray(q), u_pad)
    assert uids.dtype == torch.int32 and w.dtype == torch.float32
    assert uids.shape == (u_pad,) and w.shape == (2 * len(t), u_pad)
    assert w.is_contiguous()  # the kernels' wrappers take no strided w
    assert np.array_equal(uids.numpy(), np.asarray(want_u))
    assert np.array_equal(w.numpy(), np.asarray(want_w))


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c != "distinct_above_u_pad"])
def test_device_dedup_equals_host_dedup(case):
    """Where ``u_pad`` holds every distinct id, the device twin equals the
    host's dedup (which sizes U_pad itself), pads -2 and 0 past it."""
    t, q, _ = batch(case, 5)
    want_u, want_w = dedup_query_terms(t, q)
    uids, w = dedup_query_terms_device(torch.from_numpy(t),
                                       torch.from_numpy(q), want_u.size)
    assert np.array_equal(uids.numpy(), want_u)
    assert np.array_equal(w.numpy(), want_w)
    n = int((want_u >= 0).sum())
    assert (uids[n:] == -2).all() and (w[:, n:] == 0).all()


def test_the_drop_keeps_the_smallest_ids():
    """Beyond ``u_pad`` the ``u_pad`` smallest ids stay; a dropped id's
    weight and presence go nowhere."""
    t = np.array([[9, 3, 7, -1], [3, 11, 5, 5]], np.int32)
    q = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.float32)
    uids, w = dedup_query_terms_device(torch.from_numpy(t),
                                       torch.from_numpy(q), 3)
    assert uids.tolist() == [3, 5, 7]
    assert w.tolist() == [[2, 0, 3], [4, 13, 0], [1, 0, 1], [1, 1, 0]]


def test_device_dedup_feeds_the_udedup_wrappers():
    """On the CPU the wrappers take their plain versions: fed from the
    device dedup they give the host route's keyed scores exactly."""
    from modern_search_engines_project_tpu_torch.config import Config
    from modern_search_engines_project_tpu_torch.models import HashingEncoder
    from modern_search_engines_project_tpu_torch.retrieval import SearchEngine
    from modern_search_engines_project_tpu_torch.synthetic import (
        make_artifacts,
    )

    art, _, _ = make_artifacts(3, n_docs=1500, n_terms=400,
                               nnz_target=30_000, dim=16)
    didx = SearchEngine(art, HashingEncoder(dim=16), Config(embedding_dim=16),
                        device="cpu").didx
    rng = np.random.default_rng(4)
    t = rng.integers(0, 400, (16, 6)).astype(np.int32)
    t[:, -1] = -1
    q = np.where(t >= 0, 1.0, 0.0).astype(np.float32)
    uids_h, w_h = dedup_query_terms(t, q)
    uids_d, w_d = dedup_query_terms_device(torch.from_numpy(t),
                                           torch.from_numpy(q), uids_h.size)
    for variant in ("sublane", "i8"):
        want = bm25_score_slots_udedup(didx, torch.from_numpy(uids_h),
                                       torch.from_numpy(w_h), variant)
        got = bm25_score_slots_udedup(didx, uids_d, w_d, variant)
        assert torch.equal(got, want), variant
