"""The tensor-core U-dedup variants of the slot layout, TPU kernels 5
("acc") and 6 ("wide", "wide_i8"): their plain versions against the
reference's Pallas kernels (interpret mode on the CPU), the legacy
``variant=None`` default, the wrappers' launch arguments, and the port's
U-dedup A/B bench (``bench_kernels``) on the CPU.

Tolerances: keyed scores to 1e-5, as for kernels 1-3.  "wide" and
"wide_i8" fuse the reference's per-sublane products into one, which
changes no value, so they equal "sublane" and "i8" bit for bit; "acc"
sums a 3-way bf16 split in another order (an ulp or two).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modern_search_engines_project_tpu.retrieval import bm25_pallas as ref
from modern_search_engines_project_tpu.retrieval import ops as ref_ops
from modern_search_engines_project_tpu_torch import bench_kernels
from modern_search_engines_project_tpu_torch.retrieval import bm25_slots as port
from modern_search_engines_project_tpu_torch.retrieval import ops
from test_torch_bm25_slots import Recorder, _queries, built, meta, wide_batch  # noqa: F401

ATOL = 1e-5
MMA = ("acc", "wide", "wide_i8")


def _ref_udedup(ri, uids, w, **kw):
    return np.asarray(
        ref.bm25_score_slots_udedup(
            ri.slot_terms, ri.slot_impact, ri.col_unperm,
            jnp.asarray(uids), jnp.asarray(w), interpret=True, **kw,
        )
    )


def _port_udedup(pi, uids, w, *args, **kw):
    return port.bm25_score_slots_udedup(
        pi, torch.as_tensor(uids), torch.as_tensor(w), *args, **kw
    ).numpy()


@pytest.mark.parametrize("variant", MMA)
@pytest.mark.parametrize("B", [1, 8, 32])
def test_mma_plain_versions_match_reference(built, variant, B):
    art, ri, pi = built
    tids, qtf = _queries(100 + B, B, 8, art.n_terms)
    uids, w = ref.dedup_query_terms(tids, qtf)
    want = _ref_udedup(ri, uids, w, variant=variant)
    got = _port_udedup(pi, uids, w, variant)
    assert got.shape == want.shape == (B, pi.n_docs_pad + 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.array_equal(got < 0, want < 0)
    assert (want >= 0).any()


@pytest.mark.parametrize("variant,same", [("wide", "sublane"), ("wide_i8", "i8")])
@pytest.mark.parametrize("B", [8, 32])
def test_wide_equals_lookup_variants_bit_for_bit(built, variant, same, B):
    """As in the reference (interpret mode), "wide" equals "sublane" and
    "wide_i8" equals "i8" bit for bit, in the port too."""
    art, ri, pi = built
    tids, qtf = _queries(100 + B, B, 8, art.n_terms)
    uids, w = ref.dedup_query_terms(tids, qtf)
    assert np.array_equal(_ref_udedup(ri, uids, w, variant=variant),
                          _ref_udedup(ri, uids, w, variant=same))
    assert np.array_equal(_port_udedup(pi, uids, w, variant),
                          _port_udedup(pi, uids, w, same))


def _presence_only(w, col):
    """w with every query's weight on column ``col`` set to 0 while its
    presence row stays 1."""
    w = w.copy()
    B = w.shape[0] // 2
    w[B:, col] = 1.0
    w[:B, col] = 0.0
    return w


def test_acc_reads_presence_rows(built):
    """"acc" takes presence from w[B:2B]: a doc that matches only a term
    present with weight 0 keys to 0 under "acc" (score 0, count 1) and to
    -1 under the variants that derive presence from the weight, in the
    port as in the reference."""
    art, ri, pi = built
    tids, qtf = _queries(7, 4, 8, art.n_terms)
    uids, w = ref.dedup_query_terms(tids, qtf)
    # the most frequent real id of the batch carries the presence-only term
    df = np.diff(np.asarray(art.indptr))
    real = np.nonzero(uids >= 0)[0]
    col = int(real[np.argmax(df[uids[real]])])
    wp = _presence_only(w, col)
    want = _ref_udedup(ri, uids, wp, variant="acc")
    got = _port_udedup(pi, uids, wp, "acc")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.array_equal(got < 0, want < 0)
    sub = _port_udedup(pi, uids, wp, "sublane")
    zero_only = (got == 0) & (sub == -1)
    assert zero_only.any()
    assert np.array_equal(zero_only,
                          (want == 0) & (_ref_udedup(ri, uids, wp,
                                                     variant="sublane") == -1))


@pytest.mark.parametrize("acc", [True, False])
def test_legacy_default_scores_match_reference(built, acc):
    """variant=None: "acc" when ``acc`` (the default), else "sublane", as
    the reference's ``bm25_score_slots_udedup``."""
    art, ri, pi = built
    tids, qtf = _queries(5, 8, 8, art.n_terms)
    uids, w = ref.dedup_query_terms(tids, qtf)
    w = _presence_only(w, 0)  # "acc" and "sublane" key differently here
    want = _ref_udedup(ri, uids, w, acc=acc)
    got = _port_udedup(pi, uids, w, acc=acc)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.array_equal(got < 0, want < 0)
    named = "acc" if acc else "sublane"
    assert np.array_equal(got, _port_udedup(pi, uids, w, named))
    if acc:  # the default is the legacy "acc"
        assert np.array_equal(got, _port_udedup(pi, uids, w))
    assert not np.array_equal(got < 0, _port_udedup(pi, uids, w, acc=not acc) < 0)


@pytest.mark.parametrize("acc", [True, False])
def test_legacy_default_hybrid_rank_matches_reference(built, acc):
    """``ops.hybrid_rank_slots_udedup`` with no ``variant`` against the
    reference's with its defaults: same candidates, fused scores to 1e-5."""
    art, ri, pi = built
    tids, qtf = _queries(9, 8, 8, art.n_terms)
    uids, w = ref.dedup_query_terms(tids, qtf)
    w = _presence_only(w, 0)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k_ret = 20
    kw = {} if acc else {"acc": False}
    want = ref_ops.hybrid_rank_slots_udedup(
        ri.slot_terms, ri.slot_impact, ri.col_unperm, ri.bucket_emb,
        ri.bucket_valid, ri.bucket_start, jnp.asarray(uids), jnp.asarray(w),
        jnp.asarray(q), n_docs_pad=ri.n_docs_pad, k_ret=k_ret,
        buckets=ri.buckets, interpret=True, **kw,
    )
    got = ops.hybrid_rank_slots_udedup(
        pi, torch.as_tensor(uids), torch.as_tensor(w), torch.as_tensor(q),
        k_ret=k_ret, **kw,
    )
    doc_w, fused_w, _, _, valid_w = (np.asarray(x) for x in want)
    doc_g, fused_g, _, _, valid_g = (x.numpy() for x in got)
    assert np.array_equal(valid_g, valid_w)
    np.testing.assert_allclose(fused_g, fused_w, atol=ATOL, rtol=0)
    ties = np.isclose(fused_w[:, 1:], fused_w[:, :-1], atol=ATOL)
    same = doc_g == doc_w
    assert same[:, 0].all() or ties[:, 0].any()
    assert (same | ~valid_w).mean() > 0.9
    named = ops.hybrid_rank_slots_udedup(
        pi, torch.as_tensor(uids), torch.as_tensor(w), torch.as_tensor(q),
        k_ret=k_ret, variant="acc" if acc else "sublane",
    )
    for a, b in zip(got, named):
        assert torch.equal(a, b)


def test_mma_wrappers_pass_any_u(built, monkeypatch):
    """Kernels 5 and 6 take U = 1152: above 1024 a device-memory uid table
    of 2 * 4096 int32, the stream's group order and slot count as kernels
    1-3 take them, and always A-fragment scratch of 512 bytes for each m16
    tile of the queries and k block of the ids (bf16 k16 blocks of w[:B]
    for "wide", int8 k32 blocks for "wide_i8", bf16 k16 blocks of rows
    [0, B) and [B, 2B) for "acc")."""
    _, _, pi = built
    stream = dataclasses.replace(
        pi.slot_stream,
        **{f.name: meta(getattr(pi.slot_stream, f.name))
           for f in dataclasses.fields(pi.slot_stream)},
    )
    views = (pi.slot_terms, pi.slot_impact)
    rec = Recorder(monkeypatch, *(port.UDEDUP_KERNELS[v] for v in MMA))
    tids, qtf, uids, w = wide_batch()
    assert uids.size == 1152
    per = {"acc": 4, "wide": 2, "wide_i8": 1}
    for variant in MMA:
        out = port.slots_udedup_keyed(stream, *views, meta(uids), meta(w),
                                      variant)
        assert out.shape == (17, stream.n_cols)
        name, args = rec.calls[-1]
        assert name == port.UDEDUP_KERNELS[variant].name
        assert args[6] == 1152 and args[8] == 17
        assert args[12] == 2 * 4096  # the uid table
        assert args[13:15] == port._stream_args(stream)
        assert len(args) == 17
        assert args[-1] == per[variant] * 32 * 1152
        assert args[-1] == port.weight_scratch_bytes(variant, 17, 1152)
    small_u, small_w = port.dedup_query_terms(tids[:1, :8], qtf[:1, :8])
    assert small_u.size == 128
    for variant, n in (("acc", 4 * 16 * 128), ("wide", 2 * 16 * 128),
                       ("wide_i8", 16 * 128)):
        port.slots_udedup_keyed(stream, *views, meta(small_u), meta(small_w),
                                variant)
        args = rec.calls[-1][1]
        assert args[11:13] == (0, 0) and args[-1] == n


def _wide_mma_loop(stream, uids, B, k):
    """Kernel 6's schedule written out: every 16-row stage of every group,
    every tile of 8 columns, step j over the j-th matches of its columns,
    one mma.sync a distinct k block of those matches and m16 tile."""
    terms = stream.terms.numpy()
    pos = {int(t): u for u, t in enumerate(uids.tolist()) if t >= 0}
    n = 0
    for off, rows in zip(stream.group_off.tolist(), stream.group_rows.tolist()):
        grid = terms[off:off + rows * port.SLOT_COLS].reshape(rows, -1)
        for r0 in range(0, rows, 16):
            for c0 in range(0, port.SLOT_COLS, 8):
                lists = [[pos[t] for t in grid[r0:r0 + 16, c].tolist()
                          if t in pos] for c in range(c0, c0 + 8)]
                for j in range(max(map(len, lists))):
                    n += len({lst[j] // k for lst in lists if j < len(lst)})
    return n * -(-B // 16)


@pytest.mark.parametrize("variant,B", [("wide", 1), ("wide", 64),
                                       ("wide_i8", 17), ("wide_i8", 128)])
def test_wide_mma_count_is_the_kernel_schedule(variant, B):
    """chip_smoke.py's ``wide_mma_count`` (kernel 6's tensor-core work, in
    its log) against a loop over the kernel's stages, tiles and steps, on
    groups of several depths with shuffled ids and pads."""
    from chip_smoke import wide_mma_count
    from modern_search_engines_project_tpu_torch.retrieval.device_index import (
        build_slot_postings,
        pack_slot_classes,
    )

    rng = np.random.default_rng(B)
    n_docs, n_terms = 1500, 400
    docs = rng.integers(0, n_docs, 40_000)
    heavy = docs < 300  # a few deep groups: several strides
    docs = np.concatenate([docs, np.repeat(docs[heavy], 3)])
    terms = rng.zipf(1.3, docs.size) % n_terms
    pairs = np.unique(terms.astype(np.int64) * n_docs + docs)
    t, d = pairs // n_docs, (pairs % n_docs).astype(np.int32)
    indptr = np.zeros(n_terms + 1, np.int64)
    np.cumsum(np.bincount(t, minlength=n_terms), out=indptr[1:])
    imp = rng.gamma(2.0, 1.5, d.size).astype(np.float32)
    st, si, _ = build_slot_postings(indptr, d, imp, n_docs)
    _, _, stream = pack_slot_classes(st, si, "cpu")
    assert len(set(stream.group_rows.tolist())) > 1
    uids = np.full(384, -2, np.int32)
    uids[:300] = rng.choice(n_terms, 300, replace=False)
    uids = torch.as_tensor(rng.permutation(uids))
    k = 32 if variant == "wide_i8" else 16
    got = wide_mma_count(stream, uids, B, variant)
    assert got == _wide_mma_loop(stream, uids, B, k) > 0
    none = torch.full((128,), -2, dtype=torch.int32)
    assert wide_mma_count(stream, none, B, variant) == 0


def test_plain_versions_refuse_unknown_variant(built):
    _, _, pi = built
    uids, w = port.dedup_query_terms(np.array([[1, 2]], np.int32),
                                     np.ones((1, 2), np.float32))
    with pytest.raises(ValueError):
        port.slots_udedup_plain(pi.slot_terms, pi.slot_impact,
                                torch.as_tensor(uids), torch.as_tensor(w),
                                "blocked")


# ---- the U-dedup A/B bench on the CPU ---------------------------------------


@pytest.fixture(scope="module")
def bench_index():
    return bench_kernels.build_index(2000, "cpu")


def test_bench_cells_are_the_reference_bench_cells():
    """B x U and the variants of the JAX bench's gate_fit mode
    (bench_kernels.py:179-201)."""
    assert bench_kernels.B_CELLS == (16, 64)
    assert bench_kernels.U_CELLS == (128, 256, 512, 1024)
    assert set(bench_kernels.VARIANTS) == set(ref._UDEDUP_KERNELS)
    assert bench_kernels.N_SCAN == 32 and bench_kernels.T_PLAIN == 16


def test_bench_gate_fit_on_cpu(bench_index):
    """Cell keys, the floor correction, the gate's pick and agreement, and
    parity with kernel 2, on a 2,000-doc index (host-clock times)."""
    didx, nnz, dfs = bench_index
    assert nnz > 100_000
    u_cells = (128, 256)
    rows, gate, par = bench_kernels.gate_fit(didx, dfs, n_scan=1,
                                             u_cells=u_cells)
    cells = {f"B{B}_U{U}" for B in (16, 64) for U in u_cells}
    assert set(gate) == set(par) == cells
    for B in (16, 64):
        floor = rows[f"floor_b{B}"]
        assert floor > 0
        for U in u_cells:
            c = gate[f"B{B}_U{U}"]
            assert c["floor"] == floor
            assert c["plain"] == rows[f"plain_b{B}"] - floor
            for v in bench_kernels.VARIANTS:
                assert c[v] == rows[f"ud_{v}_b{B}_U{U}"] - floor
            meas = {k: c[k] for k in ("plain", *bench_kernels.VARIANTS)}
            assert c["measured_winner"] == min(meas, key=meas.get)
            assert c["gate_pick"] == (port.udedup_plan(U, B) or "plain")
            assert c["agree"] == (
                meas[c["gate_pick"]] <= 1.10 * meas[c["measured_winner"]] + 0.05
            )
            p = par[f"B{B}_U{U}"]
            assert all(r["within_tol"] for r in p.values())
            assert p["i8"]["bit_identical"] and p["wide"]["bit_identical"]
            assert p["wide_i8"]["bit_identical"]


def test_bench_weights_are_the_reference_formula():
    g = torch.Generator().manual_seed(3)
    w = bench_kernels.bench_weights(g, 4, 128, "cpu")
    z = torch.randn(8, 128, generator=torch.Generator().manual_seed(3))
    assert torch.equal(w, torch.floor(3.0 * z.abs()) + 1.0)
    assert w.shape == (8, 128) and (w >= 1).all() and (w == w.round()).all()


def test_bench_run_reports_parity_as_json(monkeypatch):
    """The entry point's parity-only mode on the CPU: one JSON-ready dict
    with every cell; without a card the default device raises."""
    import json

    res = bench_kernels.run(2000, "variants", device="cpu")
    json.dumps(res)
    assert res["device"].startswith("cpu") and res["n_docs"] == 2000
    assert set(res["parity"]) == {
        f"B{B}_U{U}" for B in (16, 64) for U in (128, 256, 512, 1024)
    }
    assert "gate_fit" not in res
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench_kernels.run(2000, "gate_fit")
