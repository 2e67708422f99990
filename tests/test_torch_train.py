"""The torch port's training path (``models/train.py``, ``models/data.py``,
``train_cross_encoder``, ``models/train_cli.py``, ``eval/metrics.py``,
``eval/encoder_quality.py``) against the reference package on the CPU.

Each case sends the same tree and batch (made with numpy from fixed
seeds) to the reference's JAX function and to the port with
``device="cpu"``, at the tiny width ``tests/test_models.py`` uses.

Tolerances.  At ``dtype="float32"`` both sides run the same f32
arithmetic in other orders: losses agree to 1e-5 and every gradient
leaf to 1e-4 of its largest magnitude (measured: 1e-6 and 1.6e-6).  At
the default bf16 the activations are rounded to bf16 after each product
on both sides, an ulp apart now and then, and the token table's
gradient accumulates in f32 in the port and in bf16 in the reference:
unit embeddings an ulp apart (2^-8) move a cosine by ~4e-3 and an
InfoNCE logit by that over the temperature (0.05), so losses agree to
5e-3 of their value and every gradient leaf to 5e-2 of its largest
magnitude (measured: 1.4e-3 and 1.7e-2).  The optimizer computes optax's
AdamW update in another order: parameters agree to 1e-6 after 5 steps
(measured on f32 parameters of magnitude ~1); three steps of ``Trainer.train``
in f32 give the reference's losses to 1e-4 (measured 1e-6).  Mining
compares integer picks and must be exact.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from modern_search_engines_project_tpu.eval import encoder_quality as ref_eq
from modern_search_engines_project_tpu.eval import metrics as ref_metrics
from modern_search_engines_project_tpu.models import cross_encoder as ref_ce
from modern_search_engines_project_tpu.models import data as ref_data
from modern_search_engines_project_tpu.models import train as ref
from modern_search_engines_project_tpu.models.encoder import BiEncoder as RefBiEncoder
from modern_search_engines_project_tpu.models.encoder import EncoderConfig as RefCfg
from modern_search_engines_project_tpu.models.hash_encoder import (
    HashingEncoder as RefHashing,
)
from modern_search_engines_project_tpu_torch.eval import encoder_quality as eq
from modern_search_engines_project_tpu_torch.eval import metrics
from modern_search_engines_project_tpu_torch.models import (
    BiEncoder,
    EncoderConfig,
    HashingEncoder,
    TorchEncoder,
    cross_encoder_params_to_reference,
    init_reference_params,
    params_from_reference,
    params_to_reference,
    train_cross_encoder,
)
from modern_search_engines_project_tpu_torch.models import data
from modern_search_engines_project_tpu_torch.models import train as port
from modern_search_engines_project_tpu_torch.models import train_cli

TINY = dict(vocab_size=512, dim=32, n_layers=2, n_heads=2, max_len=24)
F32 = dict(loss=1e-5, loss_rel=0.0, grad=1e-4)
BF16 = dict(loss=0.0, loss_rel=5e-3, grad=5e-2)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v, np.float32)


def tree_of(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return init_reference_params(
        cfg, lambda s: rng.standard_normal(s, dtype=np.float32))


def texts(rng, n, n_words, vocab=40):
    words = [f"w{i}q" for i in range(vocab)]
    return [" ".join(rng.choice(words, n_words)) for _ in range(n)]


def triples_for(loss, seed=0, B=8):
    """A batch with duplicate queries and passages (infonce) and a mined
    negative equal to its row's own positive (infonce_hn)."""
    rng = np.random.default_rng(seed)
    qs, ps, ns = texts(rng, B, 3), texts(rng, B, 9), texts(rng, B, 7)
    qs[3] = qs[1]
    ps[5] = ps[2]
    ns[4] = ps[4]
    if loss == "infonce_hn":
        return list(zip(qs, ps, ns))
    return [(q, p, float(i % 2)) for i, (q, p) in enumerate(zip(qs, ps))]


def ref_loss_and_grads(cfg, tcfg, tree, batch):
    model = RefBiEncoder(RefCfg(**dataclasses.asdict(cfg)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if tcfg.loss == "cosine":
        fn = lambda p: ref.cosine_loss(model, p, jb)  # noqa: E731
    else:
        fn = lambda p: ref.infonce_loss(model, p, jb, tcfg.temperature)  # noqa: E731
    loss, grads = jax.value_and_grad(fn)(jax.tree_util.tree_map(jnp.asarray, tree))
    return float(loss), dict(leaves(grads))


def port_loss_and_grads(trainer, batch):
    loss = trainer.loss(trainer.upload_batch(batch))
    loss.backward()
    grads = {n: p.grad for n, p in trainer.model.named_parameters()}
    return float(loss.detach()), dict(leaves(params_to_reference(grads)))


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("loss", ["cosine", "infonce", "infonce_hn"])
def test_loss_and_gradients_match_reference(dtype, tol, loss):
    cfg = EncoderConfig(**TINY, dtype=dtype)
    tcfg = port.TrainConfig(loss=loss, max_len=16)
    tree = tree_of(cfg)
    tr = port.Trainer(cfg, tcfg, device="cpu").init(10, params=tree)
    batch = tr.encode_pairs(triples_for(loss))
    if loss == "infonce":  # the duplicate masks are live
        assert (batch["qid"][3] == batch["qid"][1]
                and batch["pid"][5] == batch["pid"][2])
    if loss == "infonce_hn":
        assert batch["nid"][4] == batch["pid"][4]
    got_loss, got = port_loss_and_grads(tr, batch)
    want_loss, want = ref_loss_and_grads(cfg, tcfg, tree, batch)
    assert abs(got_loss - want_loss) <= (
        tol["loss"] + tol["loss_rel"] * abs(want_loss)), (got_loss, want_loss)
    assert got.keys() == want.keys()
    for k in want:
        scale = np.abs(want[k]).max()
        err = np.abs(got[k] - want[k]).max()
        assert err <= tol["grad"] * scale, (k, err, scale)


def test_hashes_compare_as_int64():
    """crc32 values above 2^31 cross as int64 and compare exactly."""
    tr = port.Trainer(EncoderConfig(**TINY, dtype="float32"),
                      port.TrainConfig(loss="infonce", max_len=16),
                      device="cpu")
    batch = tr.encode_pairs(triples_for("infonce"))
    assert batch["pid"].dtype == np.uint32 and batch["pid"].max() > 2 ** 31
    dev = tr.upload_batch(batch)
    assert dev["pid"].dtype == torch.int64
    assert np.array_equal(dev["pid"].numpy(), batch["pid"].astype(np.int64))


def test_f32_masters_give_the_inference_bits():
    """Casting f32 parameters per call gives the bits of the inference copy
    that casts them once (bf16 weights), so a trained model and its
    ``to_encoder`` agree exactly."""
    cfg = EncoderConfig(**TINY)
    tree = tree_of(cfg, seed=3)
    train = BiEncoder(cfg, "cpu", param_dtype=torch.float32)
    train.load_state_dict(params_from_reference(tree, "cpu", torch.float32))
    infer = BiEncoder(cfg, "cpu")
    infer.load_state_dict(params_from_reference(tree, "cpu"))
    assert all(p.requires_grad for p in train.parameters())
    assert not any(p.requires_grad for p in infer.parameters())
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 512, (4, 12), dtype=np.int32))
    mask = torch.from_numpy((rng.random((4, 12)) < 0.8).astype(np.int32))
    with torch.no_grad():
        assert torch.equal(train(ids, mask), infer(ids, mask))
    back = params_to_reference(train)
    assert list(back) == list(tree)  # the reference init's key order
    for (ka, a), (kb, b) in zip(leaves(back), leaves(tree)):
        assert ka == kb and np.array_equal(a, b)


@pytest.mark.parametrize("total", [1, 5, 7, 50, 1000])
def test_schedule_equals_optax(total):
    tcfg = port.TrainConfig(learning_rate=3e-4, warmup_ratio=0.1)
    at = port.lr_schedule(tcfg, total)
    warm = max(1, int(total * tcfg.warmup_ratio))
    want = optax.join_schedules(
        [optax.linear_schedule(0.0, 3e-4, warm),
         optax.linear_schedule(3e-4, 0.0, max(1, total - warm))], [warm])
    assert at(0) == 0.0
    for s in range(total + 3):
        assert at(s) == float(want(s)), s


def test_optimizer_matches_optax_adamw():
    """The same gradients through optax's adamw(join_schedules) and the
    port's optimizer for 5 steps: parameters within 1e-6; step 0 (rate 0)
    leaves them as they were."""
    cfg = EncoderConfig(**TINY, dtype="float32")
    tcfg = port.TrainConfig(learning_rate=1e-2, weight_decay=0.01)
    tree = tree_of(cfg)
    tr = port.Trainer(cfg, tcfg, device="cpu").init(10, params=tree)
    tx = optax.adamw(
        optax.join_schedules(
            [optax.linear_schedule(0.0, 1e-2, 1),
             optax.linear_schedule(1e-2, 0.0, 9)], [1]),
        weight_decay=0.01)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    rng = np.random.default_rng(5)
    names = dict(tr.model.named_parameters())
    for step in range(5):
        g_tree = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape, dtype=np.float32), tree)
        sd = params_from_reference(g_tree, "cpu", torch.float32)
        for n, p in names.items():
            p.grad = sd[n].clone()
        tr.update()
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g_tree),
                               state, params)
        params = optax.apply_updates(params, upd)
        got, want = dict(leaves(tr.params)), dict(leaves(params))
        for k in want:
            if step == 0:
                assert np.array_equal(got[k], dict(leaves(tree))[k]), k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=f"step {step} {k}")


@pytest.mark.parametrize("loss", ["cosine", "infonce", "infonce_hn"])
def test_train_three_steps_matches_reference(loss):
    """``Trainer.train`` for 3 steps in f32 (shuffle, wrap-around of the
    last batch, schedule, AdamW) gives the reference's losses to 1e-4."""
    cfg = EncoderConfig(**TINY, dtype="float32")
    tcfg = port.TrainConfig(loss=loss, max_len=16, batch_size=8,
                            learning_rate=1e-2, seed=4)
    trip = (triples_for(loss, seed=1) + triples_for(loss, seed=2)
            + triples_for(loss, seed=3, B=6))  # 22 rows: the last wraps
    tree = tree_of(cfg, seed=2)
    got = port.Trainer(cfg, tcfg, device="cpu").init(3, params=tree).train(
        trip, epochs=1)
    want = ref.Trainer(RefCfg(**dataclasses.asdict(cfg)),
                       ref.TrainConfig(**dataclasses.asdict(tcfg))).init(
        3, params=tree).train(trip, epochs=1)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the caller's tree is copied, never updated in place
    assert np.array_equal(tree["ln_f"]["scale"], np.ones(32, np.float32))


def test_train_initialises_from_the_seed_and_wraps():
    cfg = EncoderConfig(**TINY, dtype="float32")
    tcfg = port.TrainConfig(loss="cosine", max_len=16, batch_size=8, seed=7)
    trip = triples_for("cosine", seed=1) + triples_for("cosine", seed=2, B=6)
    a = port.Trainer(cfg, tcfg, device="cpu")
    losses = a.train(trip, epochs=2)
    assert len(losses) == 2 and a.step_count == 2 and np.isfinite(losses).all()
    b = port.Trainer(cfg, tcfg, device="cpu").init(2)
    assert b.params["tok"]["embedding"].tolist() != []
    g = torch.Generator().manual_seed(7)
    seeded = init_reference_params(
        cfg, lambda s: torch.randn(s, generator=g).numpy())
    for (_, x), (_, y) in zip(leaves(b.params), leaves(seeded)):
        assert np.array_equal(x, y)
    enc = a.to_encoder(batch_size=4)
    assert isinstance(enc, TorchEncoder) and enc.device.type == "cpu"
    assert enc.max_len == 16 and enc.params_digest()


def test_encode_pairs_errors():
    cfg = EncoderConfig(**TINY)
    hn = port.Trainer(cfg, port.TrainConfig(loss="infonce_hn"), device="cpu")
    cos = port.Trainer(cfg, port.TrainConfig(loss="cosine"), device="cpu")
    with pytest.raises(ValueError, match="require loss='infonce_hn'"):
        cos.encode_pairs([("q", "p", "n")])
    with pytest.raises(ValueError, match="empty batch"):
        cos.encode_pairs([])
    with pytest.raises(ValueError, match="requires"):
        hn.encode_pairs([("q", "p", 1.0)])
    b = hn.encode_pairs([("q a", "p b", "n c")])
    want = ref.Trainer(RefCfg(**TINY), ref.TrainConfig(loss="infonce_hn")
                       ).encode_pairs([("q a", "p b", "n c")])
    assert b.keys() == want.keys()
    for k in want:
        assert b[k].dtype == want[k].dtype and np.array_equal(b[k], want[k]), k


def mining_pairs(n=300, seed=0):
    """Pairs whose passages are permutations of few words: the hashing
    encoder gives them equal vectors, so the pool is full of ties."""
    r = random.Random(seed)
    words = [f"t{i}q" for i in range(30)]
    out = []
    for _ in range(n):
        ws = r.sample(words, 4)
        out.append((" ".join(r.sample(ws, 2)), " ".join(ws)))
    return out


@pytest.mark.parametrize("k", [1, 5, 40])
def test_mine_hard_negatives_exact(k):
    pairs = mining_pairs()
    qs, ps = [q for q, _ in pairs], [p for _, p in pairs]
    pool = list(dict.fromkeys(ps))
    vecs = HashingEncoder(dim=64).encode_batch(pool)
    assert len({v.tobytes() for v in vecs}) < len(pool)  # ties
    got = port.mine_hard_negatives(HashingEncoder(dim=64), qs, ps, pool,
                                   k=k, device="cpu")
    want = ref.mine_hard_negatives(RefHashing(dim=64), qs, ps, pool, k=k)
    assert got == want


def test_mine_hn_triples_and_make_triples_exact():
    pairs = mining_pairs(seed=1)
    got = port.mine_hn_triples(HashingEncoder(dim=64), pairs, per_pair=2,
                               device="cpu")
    assert got == ref.mine_hn_triples(RefHashing(dim=64), pairs, per_pair=2)
    got = data.make_triples(pairs, HashingEncoder(dim=64), num_negatives=3,
                            device="cpu")
    assert got == ref_data.make_triples(pairs, RefHashing(dim=64), 3)


def test_mine_hn_triples_error_and_warning(caplog):
    with pytest.raises(ValueError, match="no non-positive candidates"):
        port.mine_hn_triples(HashingEncoder(dim=16), [("a", "x"), ("b", "x")],
                             device="cpu")
    pairs = [("a", "x"), ("b", "y"), ("c", "x")]
    with caplog.at_level("WARNING"):
        out = port.mine_hn_triples(HashingEncoder(dim=16), pairs,
                                   pool=["x", "y"], device="cpu")
    assert out == ref.mine_hn_triples(RefHashing(dim=16), pairs,
                                      pool=["x", "y"])
    assert not any("yielded no mined negative" in r.message
                   for r in caplog.records)
    with caplog.at_level("WARNING"):
        out = port.mine_hn_triples(HashingEncoder(dim=16), pairs,
                                   pool=["x", "x", "y"], per_pair=1,
                                   device="cpu")
    assert out == ref.mine_hn_triples(RefHashing(dim=16), pairs,
                                      pool=["x", "x", "y"])


def test_mining_runs_on_the_encoders_device():
    enc = TorchEncoder(EncoderConfig(**TINY), device="cpu")
    pairs = mining_pairs(n=20)
    out = port.mine_hn_triples(enc, pairs)
    assert out and all(isinstance(t[2], str) for t in out)


def test_data_copies_match_reference(tmp_path):
    assert data.synthetic_pairs(50, seed=3) == ref_data.synthetic_pairs(50, seed=3)
    p = tmp_path / "pairs.tsv"
    p.write_text("q1\tp1\n\nbad line\nq2 \t p2\tx\nq3\tp3\n", encoding="utf-8")
    for limit in (0, 2):
        assert (data.load_pairs_tsv(str(p), limit)
                == ref_data.load_pairs_tsv(str(p), limit))


def test_cross_encoder_training_matches_reference():
    """``train_cross_encoder`` from the reference's init in f32: the same
    shuffle, tail drop, BCE and AdamW (decay 1e-4, optax's default): losses
    to 1e-4 and parameters to 1e-4 after 8 steps at rate 1e-2 (measured
    1.5e-5: Adam's normalised step turns f32 rounding in a near-zero
    gradient into up to a few 1e-6 of the rate a step).  Torch's default
    decay, 1e-2, would move a parameter of 0.5 by 4e-4 over these steps."""
    cfg = EncoderConfig(**TINY, dtype="float32")
    trip = [(q, p, float(i % 3 == 0)) for i, (q, p) in
            enumerate(data.synthetic_pairs(37, seed=2))]
    kw = dict(epochs=2, batch_size=8, learning_rate=1e-2, max_len=20, seed=1)
    ref_rr, want = ref_ce.train_cross_encoder(
        trip, RefCfg(**dataclasses.asdict(cfg)), **kw)
    init = ref_ce.CrossEncoderReranker(
        RefCfg(**dataclasses.asdict(cfg)), batch_size=8, max_len=20,
        seed=1).params
    init = jax.tree_util.tree_map(np.asarray, init)
    rr, got = train_cross_encoder(trip, cfg, params=init, device="cpu", **kw)
    assert len(got) == len(want) == 8  # 37 rows: 4 batches of 8 an epoch
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    mine = dict(leaves(cross_encoder_params_to_reference(rr.model)))
    theirs = dict(leaves(jax.tree_util.tree_map(np.asarray, ref_rr.params)))
    assert mine.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(mine[k], theirs[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    s = rr.rescore("castle neckar", ["the old castle sits", "bread"])
    np.testing.assert_allclose(
        s, ref_rr.rescore("castle neckar", ["the old castle sits", "bread"]),
        rtol=0, atol=1e-5)


def test_metrics_copy_matches_reference():
    ranked = [3, 1, 4, 1, 5, 9, 2, 6]
    rels = {1: 2.0, 9: 1.0, 7: 1.0}
    for k in (1, 3, 10):
        assert metrics.recall_at_k(ranked, {1, 9, 7}, k) == \
            ref_metrics.recall_at_k(ranked, {1, 9, 7}, k)
        assert metrics.precision_at_k(ranked, {1, 9}, k) == \
            ref_metrics.precision_at_k(ranked, {1, 9}, k)
        assert metrics.ndcg_at_k(ranked, rels, k) == \
            ref_metrics.ndcg_at_k(ranked, rels, k)
        assert metrics.ranking_overlap_at_k(ranked, ranked[::-1], k) == \
            ref_metrics.ranking_overlap_at_k(ranked, ranked[::-1], k)
    run, qrels = {1: ranked, 2: [7, 8]}, {1: rels, 2: {8: 1}}
    assert metrics.evaluate_run(run, qrels, 3) == \
        ref_metrics.evaluate_run(run, qrels, 3)
    assert metrics.mrr(ranked, {9}) == ref_metrics.mrr(ranked, {9})


def test_semantic_corpus_and_hashing_metrics_match_reference():
    c, rc = eq.semantic_corpus(6, 30, seed=2), ref_eq.semantic_corpus(6, 30, seed=2)
    assert dataclasses.asdict(c) == dataclasses.asdict(rc)
    assert (eq.random_negative_triples(c.train_pairs, 2, seed=4)
            == ref_eq.random_negative_triples(rc.train_pairs, 2, seed=4))
    assert (eq.dense_retrieval_metrics(HashingEncoder(dim=64), c)
            == ref_eq.dense_retrieval_metrics(RefHashing(dim=64), rc))


def test_trained_encoder_beats_hashing(tmp_path):
    """The user's check that training helps, on the port's trainer (the
    reference's quick configuration); the checkpoint it writes reloads
    with the same digest and metrics."""
    ckpt = str(tmp_path / "ck")
    results, trained = eq.train_and_compare(
        n_topics=16, n_train_pairs=800, n_layers=1, epochs=1, lr=3e-3,
        negatives=1, ckpt_out=ckpt, device="cpu")
    h, t = results["hashing"], results["trained"]
    assert t["recall@10"] > 0.7, results
    assert t["recall@10"] > h["recall@10"] + 0.4, results
    assert t["ndcg@10"] > h["ndcg@10"] + 0.4, results
    assert t["mrr"] > h["mrr"] + 0.4, results
    again = TorchEncoder.from_checkpoint(ckpt, batch_size=64, max_len=32,
                                         device="cpu")
    c = eq.semantic_corpus(n_topics=16, n_train_pairs=8)
    assert (eq.dense_retrieval_metrics(again, c)["recall@10"]
            == eq.dense_retrieval_metrics(trained, c)["recall@10"])
    assert again.params_digest() == trained.params_digest()


def test_trained_cross_encoder_beats_untrained():
    r = eq.train_and_compare_cross_encoder(device="cpu")
    assert r["trained_mrr"] > 0.6, r
    assert r["trained_mrr"] > r["untrained_mrr"] + 0.2, r


def test_train_cli_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "enc")
    train_cli.main(["--device", "cpu", "--layers", "2", "--dim", "64",
                    "--synthetic", "256", "--out", out])
    enc = TorchEncoder.from_checkpoint(out, device="cpu")
    assert enc.cfg.n_layers == 2 and enc.cfg.dim == 64
    assert np.isfinite(enc.encode_batch(["castle neckar"])).all()


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--dp", "2", "--tp", "2"]])
def test_train_cli_refuses_a_mesh(flags, capsys, monkeypatch):
    """A (dp, tp) mesh of more cards than are visible is refused, naming
    the count (the dp x tp step itself: tests/test_torch_train_sharded.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        train_cli.main(flags)
    assert e.value.code != 0
    assert "0 visible" in capsys.readouterr().err


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EncoderConfig(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.Trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.mine_hard_negatives(HashingEncoder(dim=16), ["a"], ["b"], ["b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cross_encoder([("a", "b", 1.0)], cfg, batch_size=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--layers", "1", "--dim", "64", "--synthetic", "8"])
    with pytest.raises(ValueError, match="'dp', 'tp'"):
        port.Trainer(cfg, mesh=object(), device="cpu")
    assert port.Trainer(cfg, device="cpu").device.type == "cpu"
