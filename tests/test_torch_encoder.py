"""The torch port's bi-encoder, checkpoint reader and the engine's
device-encoder route, against the reference package on the CPU.

Each case feeds the same inputs (made with numpy from fixed seeds, or the
committed ``runs/encoder-demo`` / ``runs/encoder-real`` checkpoints)
through the reference's flax modules and the port's torch modules.

Tolerances.  Modules: each output is rounded to bf16 once on both sides,
after f32 arithmetic done in another order, so they agree to a bf16 ulp
of their scale (2^-7 relative); the RoPE rotation stays in f32 and
agrees to 2^-20 of its scale.  Whole encoders: bf16 roundings
that differ by an ulp now and then compound over the layers; unit
embeddings agree to atol 5e-3 (2 layers, 64 wide) and 2e-3 (12 layers,
768 wide) with a min cosine of 0.9999 (measured: 2.2e-3, 1.6e-3 on the
seeded weights, 5.8e-4 on ``encoder-real``).  End to end on the demo
encoder, fused scores agree to 5e-3, not 2e-3: its query and window
embeddings differ from the reference's by up to 6.7e-3 and 5.1e-3 in L2
norm (bf16 rounding, as above), so a cosine may move by their sum; the
cosines moved by up to 3.6e-3 and the fused scores (0.85 cosine, times
a positional boost up to 1.1) by up to 2.9e-3.  Doc order may differ
only between docs whose scores lie within that of each other, and the
top-10 holds the same docs.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import serialization

from corpus_util import make_corpus
from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.models import checkpoint as ref_ckpt
from modern_search_engines_project_tpu.models import encoder as ref
from modern_search_engines_project_tpu.retrieval import SearchEngine as RefEngine
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import IndexBuilder
from modern_search_engines_project_tpu_torch.models import checkpoint as port_ckpt
from modern_search_engines_project_tpu_torch.models import encoder as port
from modern_search_engines_project_tpu_torch.retrieval import SearchEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "runs", "encoder-demo")
REAL = os.path.join(ROOT, "runs", "encoder-real")
BF16_RTOL = 2.0 ** -7
TEXTS = [
    "tübingen castle tour",
    "the neckar river and the old town hall",
    "research faculty of computer science at the university of tübingen "
    "with many institutes, a library and a cafe",
    "x",
    "",
]


@pytest.fixture(scope="module")
def demo():
    tree, cfg = port_ckpt.load_encoder(DEMO)
    return tree, cfg, port.params_from_reference(tree, "cpu")


def _sub(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _close_bf16(got, want, rtol=BF16_RTOL):
    """Agree to ``rtol`` of the output's scale (its max magnitude)."""
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _acts(seed, shape, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return jnp.asarray(x, jnp.bfloat16), torch.tensor(
        np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ).bfloat16()


def _mask(seed, B, L):
    lens = np.random.default_rng(seed).integers(1, L + 1, B)
    return (np.arange(L)[None] < lens[:, None]).astype(np.int32)


# ---- modules ---------------------------------------------------------------


def test_rope_matches_reference():
    rope = ref._rope_angles(16, 32, 10000.0)
    np.testing.assert_array_equal(
        port._rope_angles(16, 32, 10000.0), rope
    )
    jx, tx = _acts(0, (3, 20, 4, 16))
    want = ref.apply_rope(jx, jnp.asarray(rope, jnp.float32))
    got = port.apply_rope(tx, torch.tensor(rope, dtype=torch.float32))
    assert got.dtype == torch.float32
    _close_bf16(got, want.astype(jnp.float32), rtol=2.0 ** -20)


def test_layernorm_matches_reference(demo):
    tree, cfg, state = demo
    ln = port.LayerNorm(cfg.dim, torch.bfloat16)
    ln.load_state_dict(_sub(state, "blocks.1.ln2."))
    jx, tx = _acts(1, (4, 16, cfg.dim), scale=3.0)
    want = fnn.LayerNorm(dtype=jnp.bfloat16).apply(
        {"params": tree["block1"]["ln2"]}, jx + 0.5
    )
    got = ln(tx + 0.5)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)


@pytest.mark.parametrize("B,L", [(2, 16), (3, 32)])
def test_attention_matches_reference(demo, B, L):
    tree, cfg, state = demo
    rcfg = ref.EncoderConfig(**dataclasses.asdict(cfg))
    att = port.Attention(cfg)
    att.load_state_dict(_sub(state, "blocks.0.attn."))
    jx, tx = _acts(2, (B, L, cfg.dim))
    mask = _mask(3, B, L) > 0
    rope = port._rope_angles(cfg.dim // cfg.n_heads, cfg.max_len, cfg.rope_base)
    want = ref.Attention(rcfg).apply(
        {"params": tree["block0"]["attn"]}, jx, jnp.asarray(mask),
        jnp.asarray(rope, jnp.float32),
    )
    got = att(tx, torch.from_numpy(mask), torch.tensor(rope, dtype=torch.float32))
    _close_bf16(got, want)


def test_geglu_matches_reference(demo):
    tree, cfg, state = demo
    mlp = port.GeGLU(cfg)
    mlp.load_state_dict(_sub(state, "blocks.1.mlp."))
    jx, tx = _acts(4, (4, 16, cfg.dim))
    want = ref.GeGLU(ref.EncoderConfig(**dataclasses.asdict(cfg))).apply(
        {"params": tree["block1"]["mlp"]}, jx
    )
    _close_bf16(mlp(tx), want)


def test_block_matches_reference(demo):
    tree, cfg, state = demo
    blk = port.Block(cfg)
    blk.load_state_dict(_sub(state, "blocks.0."))
    jx, tx = _acts(5, (3, 32, cfg.dim))
    mask = _mask(6, 3, 32) > 0
    rope = port._rope_angles(cfg.dim // cfg.n_heads, cfg.max_len, cfg.rope_base)
    want = ref.Block(ref.EncoderConfig(**dataclasses.asdict(cfg))).apply(
        {"params": tree["block0"]}, jx, jnp.asarray(mask),
        jnp.asarray(rope, jnp.float32),
    )
    got = blk(tx, torch.from_numpy(mask), torch.tensor(rope, dtype=torch.float32))
    _close_bf16(got, want)


# ---- whole encoder -----------------------------------------------------------


def _encoder_parity(tree, cfg, shapes, atol, seed=0):
    """Unit embeddings of the flax module and the port's, on random ids
    with ragged masks (CLS first, as the tokenizer frames them)."""
    model = port.BiEncoder(cfg)
    model.load_state_dict(port.params_from_reference(tree, "cpu"))
    rb = ref.BiEncoder(ref.EncoderConfig(**dataclasses.asdict(cfg)))
    fwd = jax.jit(lambda p, i, m: rb.apply({"params": p}, i, m))
    rng = np.random.default_rng(seed)
    for B, L in shapes:
        ids = rng.integers(4, cfg.vocab_size, (B, L)).astype(np.int32)
        ids[:, 0] = 1
        mask = _mask(seed + B, B, L)
        want = np.asarray(fwd(tree, ids, mask))
        with torch.no_grad():
            got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        assert got.dtype == np.float32 and got.shape == (B, cfg.dim)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
        assert np.abs(got - want).max() <= atol, (B, L, np.abs(got - want).max())
        assert (got * want).sum(1).min() >= 0.9999


def test_biencoder_matches_reference_on_demo_checkpoint(demo):
    tree, cfg, _ = demo
    _encoder_parity(tree, cfg, [(4, 16), (8, 32)], atol=5e-3)


def test_biencoder_full_width_seeded():
    """12 layers, 768 wide, 50,257 ids: the reference's default config,
    with weights drawn by ``init_reference_params`` from a numpy seed."""
    cfg = port.EncoderConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref.EncoderConfig())
    rng = np.random.default_rng(0)
    tree = port.init_reference_params(
        cfg, lambda s: rng.standard_normal(s, dtype=np.float32)
    )
    _encoder_parity(tree, cfg, [(2, 16)], atol=2e-3)


@pytest.mark.slow
def test_biencoder_matches_reference_on_real_checkpoint():
    tree, cfg = port_ckpt.load_encoder(REAL)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(port.EncoderConfig())
    _encoder_parity(tree, cfg, [(4, 16), (8, 64)], atol=2e-3)


def test_seeded_init_has_the_reference_tree_form():
    """Same key paths, shapes and dtypes as the reference's init, at the
    scale of its default inits."""
    cfg = port.EncoderConfig(vocab_size=4096, dim=128, n_layers=2, n_heads=4,
                             mlp_ratio=2, max_len=32)
    want = ref.BiEncoder(ref.EncoderConfig(**dataclasses.asdict(cfg))).init(
        jax.random.key(0), jnp.zeros((1, 32), jnp.int32),
        jnp.ones((1, 32), jnp.int32),
    )["params"]
    g = torch.Generator().manual_seed(1)
    got = port.init_reference_params(
        cfg, lambda s: torch.randn(s, generator=g).numpy()
    )
    ref_leaves = {jax.tree_util.keystr(k): np.asarray(v)
                  for k, v in jax.tree_util.tree_leaves_with_path(want)}
    port_leaves = dict(port._leaves_with_keys(got))
    assert sorted(ref_leaves) == sorted(port_leaves)
    for k, r in ref_leaves.items():
        p = port_leaves[k]
        assert p.dtype == r.dtype and p.shape == r.shape, k
        assert abs(p.std() - r.std()) <= 0.1 * max(r.std(), 1e-3), k
        if r.std() == 0:
            np.testing.assert_array_equal(p, r)


# ---- checkpoint reader ---------------------------------------------------------


def _assert_same_tree(got, want):
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    got_leaves = dict(port._leaves_with_keys(got))
    assert sorted(got_leaves) == sorted(
        jax.tree_util.keystr(k) for k in want_leaves
    )
    for k, w in want_leaves.items():
        g = got_leaves[jax.tree_util.keystr(k)]
        w = np.asarray(w)
        assert isinstance(g, (np.ndarray, np.generic)), k
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_reader_matches_msgpack_restore_on_demo():
    with open(os.path.join(DEMO, "params.msgpack"), "rb") as f:
        blob = f.read()
    _assert_same_tree(port_ckpt.restore(blob),
                      serialization.msgpack_restore(blob))


def test_reader_small_tree_of_every_leaf_kind(tmp_path):
    rng = np.random.default_rng(0)
    tree = {
        "a": {"f16": rng.standard_normal((3, 5)).astype(np.float16),
              "f32": rng.standard_normal((7,)).astype(np.float32)},
        "i32": rng.integers(-5, 5, (2, 3, 4)).astype(np.int32),
        "i64": np.arange(300, dtype=np.int64),
        "u8": np.arange(200, dtype=np.uint8),
        "empty": np.zeros((0, 3), np.float32),
        "s32": np.float32(2.5),
        "s64": np.int64(-7),
    }
    blob = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(blob)
    got = port_ckpt.restore(blob)
    _assert_same_tree(got, want)
    # scalars come back as numpy scalars, as the reference's restore gives
    assert type(got["s32"]) is type(want["s32"])
    # the f16 -> f32 restore of load_encoder, through both packages
    enc_cfg = port.EncoderConfig(vocab_size=64, dim=16, n_layers=1,
                                 n_heads=2, mlp_ratio=2, max_len=16)
    params = port.init_reference_params(
        enc_cfg, lambda s: rng.standard_normal(s, dtype=np.float32)
    )
    ref_ckpt.save_encoder(params, ref.EncoderConfig(**dataclasses.asdict(
        enc_cfg)), str(tmp_path), dtype="float16")
    got, got_cfg = port_ckpt.load_encoder(str(tmp_path))
    want, want_cfg = ref_ckpt.load_encoder(str(tmp_path))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    _assert_same_tree(got, want)
    assert all(np.asarray(v).dtype == np.float32
               for _, v in port._leaves_with_keys(got))


def test_reader_joins_chunked_arrays(monkeypatch):
    """Arrays over the serializer's chunk size are written as
    ``__msgpack_chunked_array__`` maps (forced here by a small size)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    rng = np.random.default_rng(1)
    tree = {"big": rng.standard_normal((30, 17)).astype(np.float32),
            "nested": {"big16": rng.standard_normal(500).astype(np.float16),
                       "small": np.arange(4, dtype=np.int32)}}
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    got = port_ckpt.restore(blob)
    _assert_same_tree(got, serialization.msgpack_restore(blob))
    np.testing.assert_array_equal(got["big"], tree["big"])


def test_reader_refuses_malformed_input():
    blob = serialization.msgpack_serialize({"a": np.arange(10)})
    with pytest.raises(ValueError):
        port_ckpt.restore(blob[:-3])
    with pytest.raises(ValueError):
        port_ckpt.restore(blob + b"\x00")


def test_latest_step_dir(tmp_path):
    assert port_ckpt.latest_step_dir(str(tmp_path / "none")) is None
    for d in ("step_2", "step_10", "step_x", "other"):
        (tmp_path / d).mkdir()
    got = port_ckpt.latest_step_dir(str(tmp_path))
    assert got == ref_ckpt.latest_step_dir(str(tmp_path))
    assert got.endswith("step_10")


# ---- the encode_batch protocol -------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    return (ref.JaxEncoder.from_checkpoint(DEMO, batch_size=4),
            port.TorchEncoder.from_checkpoint(DEMO, batch_size=4,
                                              device="cpu"))


def test_digest_and_describe_equal_reference(encoders):
    je, te = encoders
    assert te.params_digest() == je.params_digest()
    assert te.describe() == je.describe()
    assert te.describe()["kind"] == "jax_biencoder"
    assert te.dim == je.dim == 64
    g = torch.Generator().manual_seed(3)
    seeded = port.TorchEncoder(te.cfg, generator=g, device="cpu")
    assert seeded.params_digest() != te.params_digest()


def test_encode_batch_matches_reference(encoders):
    je, te = encoders
    assert te.len_buckets == je.len_buckets == (16, 32)
    for texts in (TEXTS, TEXTS[:1], TEXTS * 3):
        tok = [te.tokenizer.encode(t) for t in texts]
        assert te.bucket_len(tok) == je.bucket_len(tok)
        want = je.encode_batch(texts)
        got = te.encode_batch(texts)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 5e-3
        assert (got * want).sum(1).min() >= 0.9999
    np.testing.assert_allclose(te.encode(TEXTS[0]), te.encode_batch(TEXTS)[0],
                               atol=1e-4)
    dev = te.encode_batch_device(TEXTS)
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    np.testing.assert_array_equal(dev.numpy(), te.encode_batch(TEXTS))


def test_encoder_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port.EncoderConfig(vocab_size=64, dim=16, n_layers=1, n_heads=2,
                             mlp_ratio=2, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.TorchEncoder(cfg)
    assert port.TorchEncoder(cfg, device="cpu").device.type == "cpu"


# ---- the engine with the bi-encoder --------------------------------------------

CFG = dict(embedding_dim=64, window_size=64, step_size=50, top_k_retrieval=50,
           top_k_reranking=10, max_query_terms=8)
QUERIES = [
    "research square law",
    "castle river tour",
    "tübingen university library",
    "neuro tour square",
    "old town hall market",
    "chocolate festival",
]
SCORE_ATOL = 5e-3


@pytest.fixture(scope="module")
def engines(encoders):
    je, te = encoders
    docs = make_corpus(n_docs=60, seed=7)
    art = IndexBuilder(te, Config(**CFG)).build(docs)
    ref_art = RefBuilder(je, RefConfig(**CFG)).build(docs)
    assert art.encoder_meta == ref_art.encoder_meta
    eng = SearchEngine(art, te, Config(**CFG), device="cpu")
    ref_eng = RefEngine(ref_art, je, RefConfig(**CFG), use_pallas=True)
    return art, ref_art, eng, ref_eng


def _same_top(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g.similarity_score - w.similarity_score) <= SCORE_ATOL
        if g.doc_id != w.doc_id:
            near = [abs(want[j].similarity_score - w.similarity_score)
                    <= SCORE_ATOL for j in (i - 1, i + 1) if 0 <= j < len(want)]
            assert any(near), (i, g.doc_id, w.doc_id)
        else:
            assert g.window_index == w.window_index
    assert {g.doc_id for g in got} == {w.doc_id for w in want}


def test_index_embeddings_match_reference(engines):
    art, ref_art, _, _ = engines
    assert art.window_texts == ref_art.window_texts
    got, want = art.chunk_emb, np.asarray(ref_art.chunk_emb)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-3
    assert (got * want).sum(1).min() >= 0.9999


@pytest.mark.parametrize("n", [1, 6, 16])
def test_engine_matches_reference(engines, n):
    _, _, eng, ref_eng = engines
    qs = (QUERIES * 3)[:n]
    got = eng.search_batch(qs, top_k=10)
    want = ref_eng.search_batch(qs, top_k=10)
    assert any(len(r) for r in want)
    for g, w in zip(got, want):
        _same_top(g, w)
    gi = eng.search_batch_indices(qs[:2], top_k=5)
    wi = ref_eng.search_batch_indices(qs[:2], top_k=5)
    for g, w in zip(gi, wi):
        assert len(g) == len(w)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=SCORE_ATOL)


def test_dense_search_and_warmup_with_the_encoder(engines):
    _, _, eng, ref_eng = engines
    got = eng.dense_search(QUERIES[2], top_k=10)
    want = ref_eng.dense_search(QUERIES[2], top_k=10)
    assert len(got) == len(want) > 0
    _same_top(got, want)
    assert eng.warmup(batch_sizes=(1, 4)) > 0


def test_encode_queries_takes_the_device_route(engines, monkeypatch):
    """``encode_queries`` calls ``encode_batch_device`` and never
    ``encode_batch``; rows come back unit-norm as a tensor."""
    _, _, eng, _ = engines
    calls = []
    enc = eng.encoder
    orig = enc.encode_batch_device

    def spy_device(texts):
        calls.append(len(texts))
        return orig(texts) * 3.0  # unnormalised, as a raw encoder may be

    def no_host(texts):
        raise AssertionError("encode_batch called on the device route")

    monkeypatch.setattr(enc, "encode_batch_device", spy_device)
    monkeypatch.setattr(enc, "encode_batch", no_host)
    q = eng.encode_queries(["castle tour", "law"])
    assert calls == [2]
    assert isinstance(q, torch.Tensor) and q.shape == (2, 64)
    torch.testing.assert_close(q.norm(dim=1), torch.ones(2))
    res = eng.search_batch(QUERIES[:3], top_k=5)
    assert calls[1:] == [4] and len(res) == 3 and any(len(r) for r in res)
