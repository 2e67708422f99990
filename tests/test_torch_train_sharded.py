"""The port's dp x tp training step (``models/train.py``: ``Trainer(mesh=
Mesh(devices, ("dp", "tp")))``, ``ShardedBiEncoder``, ``param_spec``) and
``train_cli --dp/--tp`` against the reference's sharded trainer on its 4 x 2
mesh of virtual CPU devices (the ``eight_devices`` fixture) and against the
port's one-device step, on the CPU.

Both trainers get the same reference-form tree through ``init(params=...)``
and the same batches; the reference's step is its jitted GSPMD step
(``Trainer._step_fn``).  At ``dtype="float32"`` the only change of
arithmetic is the order of sums (XLA's partitioned products, the port's
row products summed over tp): losses of two steps agree to 1e-5 and the
parameters after them to 1e-4 (measured: ~1e-6 and ~4e-7 at lr 1e-3); the
port's sharded step against its one-device step: the losses, each
gradient leaf to 1e-4 of its largest magnitude (measured ~1e-6) and the
parameters after two steps to 1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

from modern_search_engines_project_tpu.models import train as ref
from modern_search_engines_project_tpu.models.encoder import EncoderConfig as RefCfg
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import Document, IndexBuilder
from modern_search_engines_project_tpu_torch.models import (
    EncoderConfig,
    HashingEncoder,
    TorchEncoder,
    init_reference_params,
)
from modern_search_engines_project_tpu_torch.models import train as port
from modern_search_engines_project_tpu_torch.models import train_cli
from modern_search_engines_project_tpu_torch.parallel.sharding import (
    Mesh,
    ShardedDeviceIndex,
    make_mesh,
)
from modern_search_engines_project_tpu_torch.retrieval import SearchEngine

TINY = dict(vocab_size=512, dim=32, n_layers=2, n_heads=2, max_len=24,
            dtype="float32")
CPU = torch.device("cpu")
LOSS_TOL, PARAM_TOL, LEAF_TOL = 1e-5, 1e-4, 1e-4


def cpu_mesh(dp=4, tp=2):
    return Mesh(np.array([CPU] * (dp * tp), dtype=object).reshape(dp, tp),
                ("dp", "tp"))


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


def triples_for(loss, seed=0, B=8):
    """A batch with duplicate queries and passages and a mined negative
    equal to its row's own positive (the masks the loss must span)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}q" for i in range(40)]

    def texts(n, k):
        return [" ".join(rng.choice(words, k)) for _ in range(n)]

    qs, ps, ns = texts(B, 3), texts(B, 9), texts(B, 7)
    qs[3], ps[5], ns[4] = qs[1], ps[2], ps[4]
    if loss == "infonce_hn":
        return list(zip(qs, ps, ns))
    return [(q, p, float(i % 2)) for i, (q, p) in enumerate(zip(qs, ps))]


def ref_trainer(cfg, tcfg, tree, devices):
    mesh = RefMesh(np.array(devices).reshape(4, 2), ("dp", "tp"))
    return ref.Trainer(RefCfg(**dataclasses.asdict(cfg)),
                       ref.TrainConfig(**dataclasses.asdict(tcfg)),
                       mesh=mesh).init(10, params=tree)


@pytest.mark.parametrize("loss", ["cosine", "infonce", "infonce_hn"])
def test_sharded_steps_match_reference_and_one_device(loss, eight_devices):
    cfg = EncoderConfig(**TINY)
    tcfg = port.TrainConfig(loss=loss, max_len=16, batch_size=8,
                            learning_rate=1e-3)
    tree = tree_of(cfg)
    sharded = port.Trainer(cfg, tcfg, mesh=cpu_mesh()).init(10, params=tree)
    one = port.Trainer(cfg, tcfg, device="cpu").init(10, params=tree)
    want = ref_trainer(cfg, tcfg, tree, eight_devices)
    batches = [sharded.encode_pairs(triples_for(loss, seed=s)) for s in (1, 2)]
    for batch in batches:
        got = float(sharded.step(batch))
        solo = float(one.step(batch))
        want.params, want.opt_state, w = want._step_fn(
            want.params, want.opt_state, batch)
        assert abs(got - float(w)) <= LOSS_TOL, (got, float(w))
        assert abs(got - solo) <= LOSS_TOL, (got, solo)
    got_p = dict(leaves(sharded.params))
    for k, w in leaves(jax.device_get(want.params)):
        np.testing.assert_allclose(got_p[k], w, rtol=0, atol=PARAM_TOL,
                                   err_msg=k)
    for k, w in leaves(one.params):
        np.testing.assert_allclose(got_p[k], w, rtol=0, atol=PARAM_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("loss", ["cosine", "infonce", "infonce_hn"])
@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 2), (1, 2), (2, 1)])
def test_sharded_gradients_equal_one_device(loss, dp, tp):
    """The whole batch's loss, and each parameter's gradient summed over
    the dp replicas: one loss and every gradient leaf equal the one-device
    step's (a loss taken per dp slice would differ for InfoNCE)."""
    cfg = EncoderConfig(**TINY)
    tcfg = port.TrainConfig(loss=loss, max_len=16)
    tree = tree_of(cfg, seed=1)
    sharded = port.Trainer(cfg, tcfg, mesh=cpu_mesh(dp, tp)).init(
        10, params=tree)
    one = port.Trainer(cfg, tcfg, device="cpu").init(10, params=tree)
    batch = one.encode_pairs(triples_for(loss, seed=3))
    losses = []
    for tr in (sharded, one):
        loss_t = tr.loss(tr.upload_batch(batch))
        loss_t.backward()
        losses.append(float(loss_t.detach()))
    assert abs(losses[0] - losses[1]) <= LOSS_TOL, losses
    got, want = dict(leaves(sharded.grads())), dict(leaves(one.grads()))
    assert got.keys() == want.keys()
    for k in want:
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= LEAF_TOL * scale, k


def test_layout_follows_the_reference_spec(eight_devices):
    """Each leaf's split axis is the one the reference's ``_param_spec``
    gives it; each master shard lies on its tp column's device in dp row
    0 with the shape that split gives."""
    cfg = EncoderConfig(**TINY)
    tree = tree_of(cfg)
    tr = port.Trainer(cfg, port.TrainConfig(), mesh=cpu_mesh()).init(
        params=tree)
    layout = tr.layout()
    want = ref_trainer(cfg, ref.TrainConfig(), tree, eight_devices)
    specs = {"/".join(getattr(k, "key", str(k)) for k in path): spec
             for path, spec in jax.tree_util.tree_leaves_with_path(
                 want.param_shardings(want.params),
                 is_leaf=lambda x: hasattr(x, "spec"))}
    full = dict((k.lstrip("/"), v) for k, v in leaves(tree))
    assert set(layout) == set(specs) == set(full)
    split = {}
    for path, (axis, shards) in layout.items():
        spec = tuple(specs[path].spec)
        ref_axis = next((i for i, a in enumerate(spec) if a == "tp"), None)
        assert axis == ref_axis == port.param_spec(path, full[path]), path
        split[path] = axis
        shape = list(full[path].shape)
        if axis is None:
            assert [s for _, s in shards] == [tuple(shape)], path
        else:
            shape[axis] //= 2
            assert [s for _, s in shards] == [tuple(shape)] * 2, path
        assert all(d == CPU for d, _ in shards)
    assert split["tok/embedding"] == 1
    assert split["block0/attn/qkv/kernel"] == split["block1/mlp/wi/kernel"] == 1
    assert split["block0/attn/proj/kernel"] == split["block1/mlp/wo/kernel"] == 0
    assert split["ln_f/scale"] is None and split["block0/ln1/bias"] is None
    # the gathered tree is the one put in
    for k, v in leaves(tr.params):
        assert np.array_equal(v, full[k.lstrip("/")]), k


def test_a_batch_dp_does_not_divide_is_refused(eight_devices):
    cfg = EncoderConfig(**TINY)
    tcfg = port.TrainConfig(batch_size=6, max_len=16)
    tree = tree_of(cfg)
    tr = port.Trainer(cfg, tcfg, mesh=cpu_mesh()).init(params=tree)
    batch = tr.encode_pairs(triples_for("cosine", B=6))
    with pytest.raises(ValueError, match="dp = 4"):
        tr.step(batch)
    want = ref_trainer(cfg, tcfg, tree, eight_devices)
    with pytest.raises(ValueError):  # the reference refuses it too
        want._step_fn(want.params, want.opt_state, batch)


def test_meshes_are_kept_apart():
    """The trainer takes only a ("dp", "tp") mesh; the serving index takes
    none."""
    cfg = EncoderConfig(**TINY)
    with pytest.raises(ValueError, match="'dp', 'tp'"):
        port.Trainer(cfg, mesh=make_mesh(2, device="cpu"))
    scfg = Config(embedding_dim=16, window_size=16, step_size=12)
    enc = HashingEncoder(dim=16)
    art = IndexBuilder(enc, scfg).build(
        [Document(i, f"https://s{i}.de/", "t", f"castle doc w{i}q")
         for i in range(4)])
    with pytest.raises(ValueError, match="serving mesh"):
        ShardedDeviceIndex.from_artifacts(art, cpu_mesh(2, 2), scfg)
    with pytest.raises(ValueError, match="serving mesh"):
        SearchEngine.sharded(art, enc, cpu_mesh(2, 2), scfg)
    with pytest.raises(ValueError, match="does not split"):
        port.Trainer(EncoderConfig(**{**TINY, "dim": 30, "n_heads": 2}),
                     mesh=cpu_mesh(1, 4)).init(params=tree_of(
                         EncoderConfig(**{**TINY, "dim": 30, "n_heads": 2})))


def test_train_and_to_encoder_on_a_mesh():
    cfg = EncoderConfig(**TINY)
    tcfg = port.TrainConfig(loss="infonce", max_len=16, batch_size=8, seed=4)
    tr = port.Trainer(cfg, tcfg, mesh=cpu_mesh(2, 2))
    losses = tr.train(triples_for("infonce", 1) + triples_for("infonce", 2),
                      epochs=1)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert tr.device == CPU
    enc = tr.to_encoder(batch_size=4)
    assert isinstance(enc, TorchEncoder)
    assert np.isfinite(enc.encode_batch(["w1q w2q"])).all()


def test_train_cli_dp_tp_on_the_cpu(tmp_path):
    out = str(tmp_path / "enc")
    train_cli.main(["--device", "cpu", "--dp", "2", "--tp", "2", "--layers",
                    "1", "--dim", "64", "--synthetic", "16", "--negatives",
                    "1", "--batch-size", "8", "--max-len", "16", "--out", out])
    enc = TorchEncoder.from_checkpoint(out, device="cpu")
    assert enc.cfg.n_layers == 1 and enc.cfg.dim == 64


def test_train_cli_exits_on_too_few_cards(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--dp", "2", "--tp", "2"])
    assert e.value.code != 0
    assert "needs 4 visible CUDA devices, 2 visible" in capsys.readouterr().err
