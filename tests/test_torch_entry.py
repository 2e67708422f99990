"""The port's compile check and multi-device dry run
(``modern_search_engines_project_tpu_torch/entry.py``) against the
repository's ``__graft_entry__.py`` reference paths, on the CPU.

``entry(device="cpu")`` at a reduced width against the reference's
``BiEncoder`` on the same tree: unit embeddings to 5e-3 in bf16 (the
tolerance of ``tests/test_torch_encoder.py`` at this width) and to 1e-5
in f32.  ``dryrun_multichip(8, device="cpu")`` against the reference's
steps on the same configuration and documents, run here on its 8 virtual
devices: the retrieval results equal (doc ids, windows, scores to 1e-5),
the training step's loss equals the reference's sharded step from the
same tree (bf16: 5e-3 of its value)."""

import dataclasses
import logging

import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

from modern_search_engines_project_tpu.config import Config as RefConfig
from modern_search_engines_project_tpu.index import Document as RefDocument
from modern_search_engines_project_tpu.index import IndexBuilder as RefBuilder
from modern_search_engines_project_tpu.models import HashingEncoder as RefHashing
from modern_search_engines_project_tpu.models import train as ref_train
from modern_search_engines_project_tpu.models.encoder import BiEncoder as RefBiEncoder
from modern_search_engines_project_tpu.models.encoder import EncoderConfig as RefCfg
from modern_search_engines_project_tpu.models.encoder import JaxEncoder
from modern_search_engines_project_tpu.retrieval import SearchEngine as RefEngine
from modern_search_engines_project_tpu_torch import entry as port
from modern_search_engines_project_tpu_torch.models import (
    EncoderConfig,
    init_reference_params,
)

SMALL = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, max_len=32)


@pytest.mark.parametrize("dtype,atol", [("bfloat16", 5e-3), ("float32", 1e-5)])
def test_entry_forward_matches_reference(dtype, atol):
    cfg = EncoderConfig(**SMALL, dtype=dtype)
    rng = np.random.default_rng(0)
    tree = init_reference_params(
        cfg, lambda s: rng.standard_normal(s, dtype=np.float32))
    fwd, args = port.entry(device="cpu", cfg=cfg, params=tree)
    state, ids, mask = args
    assert ids.shape == mask.shape == (8, 32)
    # random ids and a ragged mask as well as the entry's zeros and ones
    ids2 = torch.from_numpy(rng.integers(0, 512, (8, 32), dtype=np.int32))
    mask2 = torch.from_numpy((rng.random((8, 32)) < 0.7).astype(np.int32))
    model = RefBiEncoder(RefCfg(**dataclasses.asdict(cfg)))
    for i, m in ((ids, mask), (ids2, mask2)):
        got = fwd(state, i, m).float().numpy()
        want = np.asarray(model.apply({"params": tree}, i.numpy(), m.numpy()),
                          np.float32)
        assert got.shape == (8, 64)
        assert np.abs(got - want).max() <= atol


def test_entry_defaults_to_the_flagship():
    fwd, (state, ids, mask) = port.entry(device="cpu")
    assert ids.shape == (8, 512) and state["tok"].shape == (50257, 768)
    assert sum(1 for k in state if k.endswith("attn.qkv")) == 12


def test_entry_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.entry(cfg=EncoderConfig(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.dryrun_multichip(2)


def test_mesh_entries_repeat_the_visible_cards(monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with caplog.at_level(logging.INFO):
        devs = port.mesh_devices(8)
    assert [d.index for d in devs] == [0, 1, 2, 0, 1, 2, 0, 1]
    assert "repeated" in caplog.text
    assert port.mesh_devices(4, device="cpu") == [torch.device("cpu")] * 4


def rows(results):
    return [[(d.doc_id, d.window_index, d.similarity_score) for d in r]
            for r in results]


def same_rows(got, want):
    assert [[(a, b) for a, b, _ in r] for r in got] == [
        [(a, b) for a, b, _ in r] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for *_, s in g], [s for *_, s in w],
                                   rtol=0, atol=1e-5)


def test_dryrun_multichip_matches_reference(eight_devices):
    n = 8
    got = port.dryrun_multichip(n, device="cpu")
    assert got["devices"] == ["cpu"] * n
    devs = np.array(eight_devices)
    cfg = RefConfig(**dataclasses.asdict(port.dryrun_config()))
    docs = [RefDocument(d.doc_id, d.url, d.title, d.text)
            for d in port.dryrun_documents(n)]
    enc = RefHashing(dim=32)
    art = RefBuilder(enc, cfg).build(docs)
    want_b = RefEngine.sharded(art, enc, RefMesh(devs, ("shard",)),
                               cfg).search("castle museum", top_k=5)
    same_rows(rows([got["shard"]]), rows([want_b]))
    want_c = RefEngine.sharded(
        art, enc, RefMesh(devs.reshape(4, 2), ("dp", "shard")),
        cfg).search_batch(["castle museum", "river neckar"], top_k=5)
    same_rows(rows(got["dp_shard"]), rows(want_c))
    g = torch.Generator().manual_seed(1)
    tree = init_reference_params(
        port.QUERY_CFG, lambda s: torch.randn(s, generator=g).numpy())
    jenc = JaxEncoder(RefCfg(**dataclasses.asdict(port.QUERY_CFG)),
                      params=tree, batch_size=8)
    art_j = RefBuilder(jenc, cfg).build(docs[: 2 * n])
    want_d = RefEngine.sharded(art_j, jenc, RefMesh(devs, ("shard",)),
                               cfg).search_batch(
        ["castle museum", "river neckar"], top_k=3)
    same_rows(rows(got["encoder"]), rows(want_d))
    # (a): the reference's sharded step from the tree the port's trainer
    # draws (seed 0) on the same two-row batch
    g = torch.Generator().manual_seed(0)
    tree = init_reference_params(
        port.TRAIN_CFG, lambda s: torch.randn(s, generator=g).numpy())
    tcfg = ref_train.TrainConfig(batch_size=8, epochs=1, max_len=16)
    tr = ref_train.Trainer(RefCfg(**dataclasses.asdict(port.TRAIN_CFG)), tcfg,
                           mesh=RefMesh(devs.reshape(4, 2), ("dp", "tp")))
    tr.init(total_steps=1, params=tree)
    want_a = tr.train([("castle tour", "the castle overlooks the town", 1.0),
                       ("castle tour", "pizza dough recipe", 0.0)] * 4)
    assert len(got["losses"]) == len(want_a) == 1
    assert abs(got["losses"][0] - want_a[0]) <= 5e-3 * abs(want_a[0])
