"""The torch port's checkpoint writers against the reference's, on the CPU.

The port writes msgpack without flax or the ``msgpack`` package
(``models/checkpoint.py``); its bytes must equal
``flax.serialization.to_bytes`` of the same tree, so that a checkpoint
either package writes is the other's byte for byte, and each package
reads the other's files.  Bytes are compared exactly; trees read back
are compared exactly, and scores of a reloaded model to 1e-6 (the same
f32 or f16-rounded weights through other f32 arithmetic).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from modern_search_engines_project_tpu.models import checkpoint as ref_ckpt
from modern_search_engines_project_tpu.models import cross_encoder as ref_ce
from modern_search_engines_project_tpu.models import decoder as ref_dec
from modern_search_engines_project_tpu.models.encoder import BiEncoder as RefBiEncoder
from modern_search_engines_project_tpu.models.encoder import EncoderConfig as RefCfg
from modern_search_engines_project_tpu.models.word_vocab import WordVocab as RefVocab
from modern_search_engines_project_tpu_torch.models import (
    BiEncoder,
    CrossEncoderReranker,
    DecoderConfig,
    EncoderConfig,
    TorchEncoder,
    WordVocab,
    checkpoint,
    init_decoder_params,
    load_decoder,
    params_from_reference,
    params_to_reference,
    save_decoder,
    save_encoder,
)

TINY = dict(vocab_size=512, dim=32, n_layers=2, n_heads=2, max_len=24)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def same_tree(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


def np_tree(tree):
    """numpy leaves, keys in the tree's own order (a jax tree map would
    sort them)."""
    return {k: np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def sorted_tree(tree):
    return {k: sorted_tree(tree[k]) if isinstance(tree[k], dict) else tree[k]
            for k in sorted(tree)}


def ref_init(cfg):
    model = RefBiEncoder(RefCfg(**dataclasses.asdict(cfg)))
    ids = jnp.zeros((1, cfg.max_len), jnp.int32)
    return model.init(jax.random.key(3), ids, jnp.ones_like(ids))["params"]


def trees():
    rng = np.random.default_rng(0)
    long_key = "k" * 40  # str8 header
    yield "order", {"zeta": {"b": rng.standard_normal(3, dtype=np.float32)},
                    "alpha": {"a": np.arange(4, dtype=np.int32)}}
    yield "dtypes", {
        "f16": rng.standard_normal((5, 3)).astype(np.float16),
        "u8": rng.integers(0, 255, 300, dtype=np.uint8),
        "i64": np.array([-2 ** 40, -200, -5, 0, 7, 2 ** 40], np.int64),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 4), np.float32),
        "zero_d": np.array(2.5, np.float64),
        long_key: np.ones(2, np.float32),
    }
    yield "scalars", {"s32": np.float32(1.5), "i8": np.int8(-3),
                      "b": np.bool_(True), "u64": np.uint64(2 ** 63)}
    yield "shapes", {  # dims in the uint8, uint16 and uint32 int forms
        "a": np.zeros((200, 1), np.float32),
        "b": np.zeros((70000,), np.uint8),
        "c": np.zeros((1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
                      np.int16),  # 17 dims: array16 header
        "t": rng.standard_normal((4, 6), dtype=np.float32).T,  # not C-order
    }
    yield "wide_map", {f"key{i:02d}": np.array([i], np.int32)
                       for i in range(40)}  # map16 header
    yield "ext_sizes", {  # payloads of 1..70000 bytes: fixext, ext8/16/32
        str(n): np.zeros(n, np.uint8) for n in (0, 1, 2, 4, 8, 16, 200, 70000)
    }


@pytest.mark.parametrize("name,tree", list(trees()),
                         ids=[n for n, _ in trees()])
def test_to_bytes_equals_flax(name, tree):
    blob = checkpoint.to_bytes(tree)
    assert blob == serialization.to_bytes(tree)
    back = checkpoint.restore(blob)
    assert list(back) == list(tree)


def test_chunked_arrays_equal_flax(monkeypatch):
    """Arrays over ``MAX_CHUNK_SIZE`` bytes go as the reference's chunked
    maps (2^30 in both packages; shrunk here, on both sides)."""
    assert checkpoint.MAX_CHUNK_SIZE == serialization.MAX_CHUNK_SIZE == 2 ** 30
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    rng = np.random.default_rng(1)
    tree = {"big": {"kernel": rng.standard_normal((50, 70), dtype=np.float32)},
            "small": np.arange(10, dtype=np.int64),
            "odd": rng.standard_normal(3001).astype(np.float16)}
    blob = checkpoint.to_bytes(tree)
    assert blob == serialization.to_bytes(tree)
    back = checkpoint.restore(blob)
    assert np.array_equal(back["big"]["kernel"], tree["big"]["kernel"])
    assert np.array_equal(back["odd"], tree["odd"])


def test_writer_refuses_what_it_cannot_write():
    for bad in ({"a": [1, 2]}, {"a": 1.5}, {1: np.zeros(2)},
                {"a": np.array([object()])}):
        with pytest.raises((TypeError, ValueError)):
            checkpoint.to_bytes(bad)


def test_params_to_reference_keeps_the_reference_order():
    """A reference init tree through the port's module and back writes the
    bytes flax writes for the init tree itself (the init's key order)."""
    cfg = EncoderConfig(**TINY)
    init = np_tree(ref_init(cfg))
    m = BiEncoder(cfg, "cpu", param_dtype=torch.float32)
    m.load_state_dict(params_from_reference(init, "cpu", torch.float32))
    back = params_to_reference(m)
    same_tree(back, init)
    assert checkpoint.to_bytes(back) == serialization.to_bytes(init)


@pytest.mark.parametrize("dtype", [None, "float16"])
def test_save_encoder_equals_reference(tmp_path, dtype):
    cfg = EncoderConfig(**TINY)
    init = np_tree(ref_init(cfg))
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    save_encoder(init, cfg, mine, dtype=dtype)
    ref_ckpt.save_encoder(init, RefCfg(**TINY), theirs, dtype=dtype)
    for name in ("params.msgpack", "config.json"):
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    assert sorted(os.listdir(mine)) == ["config.json", "params.msgpack"]
    # each package reads the other's file, f16 restored to f32 (the
    # reference's reader returns its tree with sorted keys)
    got, got_cfg = checkpoint.load_encoder(theirs)
    want, want_cfg = ref_ckpt.load_encoder(mine)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    same_tree(sorted_tree(got), np_tree(want))
    assert all(v.dtype == np.float32 for _, v in leaves(got))


def test_trained_encoder_round_trip(tmp_path):
    """The port's writer, then both readers: the same digest and the same
    embeddings (f16 leaves) in either package."""
    from modern_search_engines_project_tpu.models.encoder import JaxEncoder

    cfg = EncoderConfig(**TINY, dtype="float32")
    rng = np.random.default_rng(4)
    tree = {k: v for k, v in params_to_reference(
        TorchEncoder(cfg, device="cpu").model).items()}
    tree["ln_f"]["scale"] = rng.standard_normal(32, dtype=np.float32)
    path = str(tmp_path / "ck")
    save_encoder(tree, cfg, path, dtype="float16")
    a = TorchEncoder.from_checkpoint(path, device="cpu")
    b = TorchEncoder.from_checkpoint(path, device="cpu")
    ref = JaxEncoder.from_checkpoint(path)
    assert a.params_digest() == b.params_digest() == ref.params_digest()
    texts = ["castle on the hill", "neckar", ""]
    np.testing.assert_allclose(a.encode_batch(texts), ref.encode_batch(texts),
                               rtol=0, atol=1e-6)


def test_save_overwrites_atomically(tmp_path):
    path = str(tmp_path / "ck")
    cfg = EncoderConfig(**TINY)
    save_encoder({"a": np.zeros(3, np.float32)}, cfg, path)
    save_encoder({"a": np.ones(3, np.float32)}, cfg, path)
    assert sorted(os.listdir(path)) == ["config.json", "params.msgpack"]
    tree, conf = checkpoint.read_checkpoint(path)
    assert np.array_equal(tree["a"], np.ones(3, np.float32))
    assert conf == dataclasses.asdict(cfg)


def test_cross_encoder_save_equals_reference(tmp_path):
    cfg = EncoderConfig(**TINY, dtype="float32")
    ref = ref_ce.CrossEncoderReranker(RefCfg(**dataclasses.asdict(cfg)),
                                      max_len=20, seed=2)
    tree = np_tree(ref.params)
    mine = CrossEncoderReranker(cfg, params=tree, max_len=20, device="cpu",
                                param_dtype=torch.float32)
    pm, pr = str(tmp_path / "port"), str(tmp_path / "ref")
    mine.save(pm)
    ref.save(pr)
    for name in ("params.msgpack", "config.json"):
        with open(os.path.join(pm, name), "rb") as a, \
                open(os.path.join(pr, name), "rb") as b:
            assert a.read() == b.read(), name
    q, docs = "castle neckar", ["the old castle on the hill", "bread", ""]
    back = ref_ce.CrossEncoderReranker.from_checkpoint(pm, max_len=20)
    ours = CrossEncoderReranker.from_checkpoint(pr, max_len=20, device="cpu")
    np.testing.assert_allclose(ours.rescore(q, docs), back.rescore(q, docs),
                               rtol=0, atol=1e-6)
    # an inference reranker saves the weights it holds
    infer = CrossEncoderReranker(cfg, params=tree, max_len=20, device="cpu")
    infer.save(str(tmp_path / "infer"), dtype=None)
    again, _ = checkpoint.read_checkpoint(str(tmp_path / "infer"))
    assert list(again) == list(tree)  # the init's order, as written
    for k, v in leaves(tree):
        assert np.array_equal(dict(leaves(again))[k], v), k


def test_save_decoder_equals_reference(tmp_path):
    texts = ["the castle sits on the hill", "the river runs below the town"]
    vocab, rvocab = WordVocab.build(texts), RefVocab.build(texts)
    cfg = DecoderConfig(vocab_size=len(vocab), dim=32, n_layers=1, n_heads=2,
                        max_len=24)
    rng = np.random.default_rng(6)
    tree = init_decoder_params(
        cfg, lambda s: rng.standard_normal(s, dtype=np.float32))
    pm, pr = str(tmp_path / "port"), str(tmp_path / "ref")
    save_decoder(tree, cfg, pm, vocab=vocab)
    ref_dec.save_decoder(tree, ref_dec.DecoderConfig(**dataclasses.asdict(cfg)),
                         pr, vocab=rvocab)
    for name in ("params.msgpack", "config.json", "vocab.json"):
        with open(os.path.join(pm, name), "rb") as a, \
                open(os.path.join(pr, name), "rb") as b:
            assert a.read() == b.read(), name
    model, got_cfg, got_vocab = load_decoder(pr, device="cpu")
    assert got_cfg == cfg and got_vocab.words == vocab.words
    _, params, _, rv = ref_dec.load_decoder(pm)
    assert rv.words == vocab.words
    got, _ = checkpoint.read_checkpoint(pm)
    same_tree(got, np_tree(params))
    save_decoder(tree, cfg, str(tmp_path / "novocab"))
    assert sorted(os.listdir(tmp_path / "novocab")) == [
        "config.json", "params.msgpack"]
    with open(os.path.join(pm, "config.json")) as f:
        assert json.load(f) == dataclasses.asdict(cfg)
