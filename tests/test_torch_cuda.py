"""Kernels of the torch port against their plain versions, on the card.

Every test here is marked ``gpu`` and skips (inside the ``cuda`` fixture)
where no CUDA device is present.  On a machine with an H100:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's shared conftest imports jax, which this file
does not need.)  Inputs are made with numpy from fixed seeds.

Tolerances: the BM25 kernels sum at most T nonzero f32 products per doc in
another order than the plain version, so keyed scores agree to 1e-5.  The
stats kernel and its plain version read the same bf16 bank and query and
sum 768 f32 products in different orders; sims agree to ~1e-6, checked at
1e-4 (slots are compared by the sim they point at, since near-equal sims
may pick different slots).
"""

import numpy as np
import pytest
import torch

from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import Document, IndexBuilder
from modern_search_engines_project_tpu_torch.models import HashingEncoder
from modern_search_engines_project_tpu_torch.retrieval import cuda_lib
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    SLOTS_KERNEL,
    UDEDUP_KERNELS,
    dedup_query_terms,
    slots_keyed,
    slots_plain,
    slots_udedup_keyed,
    slots_udedup_plain,
)
from modern_search_engines_project_tpu_torch.retrieval.dense_stats import (
    STATS_KERNEL,
    bucket_sims,
    bucket_stats,
    stats_max_abs_err,
    stats_plain,
)
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    build_slot_postings,
    pack_slot_classes,
)
from modern_search_engines_project_tpu_torch.retrieval.engine import SearchEngine

pytestmark = pytest.mark.gpu

BM25_ATOL = 1e-5
STATS_ATOL = 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _random_slots(seed, n_docs=3000, n_terms=400, nnz=60000):
    rng = np.random.default_rng(seed)
    dfs = np.maximum((1.0 / np.arange(1, n_terms + 1)) ** 0.7 * nnz / 9, 1)
    dfs = np.minimum(dfs.astype(np.int64), n_docs)
    pairs = np.unique(
        np.repeat(np.arange(n_terms), dfs) * n_docs
        + rng.integers(0, n_docs, int(dfs.sum()))
    )
    terms, docs = pairs // n_docs, (pairs % n_docs).astype(np.int32)
    indptr = np.zeros(n_terms + 1, np.int64)
    np.cumsum(np.bincount(terms, minlength=n_terms), out=indptr[1:])
    impact = rng.gamma(2.0, 1.5, docs.size).astype(np.float32)
    impact[::97] = 0.0  # matched with score 0 stays admissible
    impact[::89] *= -1  # negative scores key to -1
    n_docs_pad = -(-n_docs // 128) * 128
    st, si, _ = build_slot_postings(indptr, docs, impact, n_docs_pad)
    return st, si, n_terms, rng


@pytest.fixture(scope="module")
def slots(cuda):
    st, si, n_terms, rng = _random_slots(0)
    views_t, views_i, stream = pack_slot_classes(st, si, cuda)
    return views_t, views_i, stream, n_terms, rng


def _queries(rng, B, T, n_terms):
    tids = rng.integers(-1, n_terms, (B, T)).astype(np.int32)
    qtf = np.where(tids >= 0, rng.integers(1, 4, (B, T)), 0)
    return tids, qtf.astype(np.float32)


def test_library_builds(cuda):
    cuda_lib.load()
    assert cuda_lib.library_path().exists()
    print(cuda_lib.build_log())


@pytest.mark.parametrize("B,T", [(1, 4), (5, 8), (16, 16), (64, 8)])
def test_slots_kernel_matches_plain(slots, cuda, B, T):
    views_t, views_i, stream, n_terms, rng = slots
    tids, qtf = _queries(rng, B, T, n_terms)
    tids_t = torch.as_tensor(tids, device=cuda)
    qtf_t = torch.as_tensor(qtf, device=cuda)
    before = SLOTS_KERNEL.launches
    got = slots_keyed(stream, views_t, views_i, tids_t, qtf_t)
    torch.cuda.synchronize()
    assert SLOTS_KERNEL.launches == before + 1
    want = slots_plain(views_t, views_i, tids_t, qtf_t)
    torch.testing.assert_close(got, want, atol=BM25_ATOL, rtol=0)
    assert (got >= 0).any() and (got == -1).any()


@pytest.mark.parametrize("variant", ["sublane", "i8"])
@pytest.mark.parametrize("B,T", [(8, 4), (16, 8), (64, 16)])
def test_udedup_kernels_match_plain(slots, cuda, variant, B, T):
    views_t, views_i, stream, n_terms, rng = slots
    tids, qtf = _queries(rng, B, T, n_terms)
    uids, w = dedup_query_terms(tids, qtf)
    uids_t = torch.as_tensor(uids, device=cuda)
    w_t = torch.as_tensor(w, device=cuda)
    got = slots_udedup_keyed(stream, views_t, views_i, uids_t, w_t, variant)
    want = slots_udedup_plain(views_t, views_i, uids_t, w_t, variant)
    torch.testing.assert_close(got, want, atol=BM25_ATOL, rtol=0)
    # both U-dedup kernels and the plain kernel give the same keyed scores
    plain = slots_keyed(
        stream, views_t, views_i,
        torch.as_tensor(tids, device=cuda), torch.as_tensor(qtf, device=cuda),
    )
    torch.testing.assert_close(got, plain, atol=BM25_ATOL, rtol=0)


def test_udedup_kernel_takes_unsorted_uids(slots, cuda):
    views_t, views_i, stream, n_terms, rng = slots
    tids, qtf = _queries(rng, 16, 8, n_terms)
    uids, w = dedup_query_terms(tids, qtf)
    perm = rng.permutation(uids.size)
    uids_t = torch.as_tensor(uids[perm], device=cuda)
    w_t = torch.as_tensor(np.ascontiguousarray(w[:, perm]), device=cuda)
    got = slots_udedup_keyed(stream, views_t, views_i, uids_t, w_t, "sublane")
    want = slots_udedup_plain(views_t, views_i, uids_t, w_t, "sublane")
    torch.testing.assert_close(got, want, atol=BM25_ATOL, rtol=0)


@pytest.mark.parametrize(
    "n,cnt,B,dim", [(1, 100, 1, 64), (3, 1000, 16, 768), (10, 257, 64, 768),
                    (2, 8, 17, 96)]
)
def test_stats_kernel_matches_plain(cuda, n, cnt, B, dim):
    rng = np.random.default_rng(n * 1000 + cnt)
    e = rng.standard_normal((n, cnt, dim)).astype(np.float32)
    if n > 1:
        e[1, : cnt // 3] = e[0, : cnt // 3]  # exact ties between slots
    emb = torch.as_tensor(e, device=cuda).to(torch.bfloat16)
    q = torch.as_tensor(rng.standard_normal((B, dim)), device=cuda).float()
    before = STATS_KERNEL.launches
    got = bucket_stats(emb, q)
    torch.cuda.synchronize()
    assert STATS_KERNEL.launches == before + 1
    want = stats_plain(emb, q)
    assert stats_max_abs_err(got, want, bucket_sims(emb, q)) <= STATS_ATOL


def test_wrappers_refuse_wrong_inputs(slots, cuda):
    views_t, views_i, stream, n_terms, _ = slots
    tids = torch.zeros(2, 4, dtype=torch.int64, device=cuda)
    qtf = torch.ones(2, 4, device=cuda)
    with pytest.raises(TypeError):
        slots_keyed(stream, views_t, views_i, tids, qtf)
    emb = torch.zeros(2, 8, 64, device=cuda)  # f32 bank: the kernel takes bf16
    with pytest.raises(TypeError):
        bucket_stats(emb, torch.zeros(1, 64, device=cuda))


def _docs(seed, n=300):
    rng = np.random.default_rng(seed)
    abc = "abcdefghijklmnopqrstuvwxyz"
    words = [f"w{a}{b}q" for a in abc for b in abc]
    docs = []
    for i in range(n):
        k = int(rng.integers(20, 400))
        idx = np.minimum(rng.zipf(1.3, k) - 1, len(words) - 1)
        text = " ".join(words[j] for j in idx)
        if rng.random() < 0.7:
            text += " tübingen"
        docs.append(
            Document(i, f"https://www.s{i % 23}.de/p{i}", f"t{i}", text)
        )
    return docs, words


def test_engine_on_card_matches_cpu(cuda):
    docs, words = _docs(1)
    cfg = Config(embedding_dim=64, window_size=64, step_size=50,
                 top_k_retrieval=200, top_k_reranking=10)
    enc = HashingEncoder(dim=64)
    art = IndexBuilder(enc, cfg).build(docs)
    gpu = SearchEngine(art, enc, cfg)
    cpu = SearchEngine(art, enc, cfg, bank_dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(2)
    counts = {k.name: k.launches for k in cuda_lib.KERNELS}
    for B in (1, 16, 64):
        qs = [" ".join(rng.choice(words, 4)) for _ in range(B)]
        got, want = gpu.search_batch(qs, top_k=10), cpu.search_batch(qs, top_k=10)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert abs(a.similarity_score - b.similarity_score) < 1e-3
    for k in cuda_lib.KERNELS:
        assert k.launches > counts[k.name], k.name
    assert UDEDUP_KERNELS["sublane"].launches > counts["bm25_slots_udedup_sublane"]
