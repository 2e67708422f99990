"""The project's compile check and multi-device dry run.

``entry()``               the forward step of the flagship model, the
                          12-layer, 768-wide ``BiEncoder`` (the query and
                          window encoder, ``models/encoder.py``), at
                          (B, L) = (8, 512): ``fwd(*args)`` runs it.
``dryrun_multichip(n)``   over a mesh of ``n`` entries, one tiny step of
                          each multi-device path: (a) one dp x tp training
                          step of the bi-encoder, (b) one sharded hybrid
                          retrieval batch over a ("shard",) mesh, (c) the
                          (dp, shard) deployment mesh, (d) the query
                          encoder split over the mesh
                          (``ShardedQueryEncoder``).

Counterpart of the repository's ``__graft_entry__.py`` (its tiny
configurations and documents).  Both run on the card unless the caller
passes ``device="cpu"``; with no card and no ``device="cpu"`` they raise.
A mesh entry is a visible card; when fewer than ``n`` are visible the
cards repeat in turn (the log says so), as ``device="cpu"`` repeats the
CPU.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from modern_search_engines_project_tpu_torch.models.encoder import (
    BiEncoder,
    EncoderConfig,
    init_reference_params,
    params_from_reference,
)
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    resolve_device,
)

log = logging.getLogger(__name__)

# the dry run's tiny encoders and its training and retrieval configuration
TRAIN_CFG = EncoderConfig(vocab_size=512, dim=64, n_layers=2, n_heads=4,
                          mlp_ratio=2, max_len=16)
QUERY_CFG = EncoderConfig(vocab_size=512, dim=32, n_layers=2, n_heads=4,
                          mlp_ratio=2, max_len=16)


def entry(device=None, cfg: Optional[EncoderConfig] = None,
          params: Optional[dict] = None):
    """(fwd, args): ``fwd(*args)`` is the bi-encoder's forward, ids and
    mask [8, cfg.max_len] -> unit embeddings [8, dim], on ``device``.
    ``cfg`` defaults to the flagship ``EncoderConfig()`` (12L/768d, 512
    positions); ``params`` (a tree in the reference's form) to one drawn
    from seed 0.  ``args`` = (the state dict, ids of zeros, mask of
    ones)."""
    dev = resolve_device(device)
    cfg = cfg or EncoderConfig()
    if params is None:
        g = torch.Generator().manual_seed(0)
        params = init_reference_params(
            cfg, lambda s: torch.randn(s, generator=g).numpy())
    model = BiEncoder(cfg, dev)
    state = params_from_reference(params, dev, getattr(torch, cfg.dtype))
    B, L = 8, cfg.max_len
    ids = torch.zeros((B, L), dtype=torch.int32, device=dev)
    mask = torch.ones((B, L), dtype=torch.int32, device=dev)

    def fwd(state, ids, mask):
        with torch.no_grad():
            return torch.func.functional_call(model, state, (ids, mask))

    return fwd, (state, ids, mask)


def mesh_devices(n_devices: int, device=None) -> list:
    """``n_devices`` mesh entries: the visible cards, repeated in turn
    when fewer are visible, or the CPU ``n_devices`` times."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return [torch.device("cpu")] * n_devices
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 1:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for a CPU dry run")
    if count < n_devices:
        log.info("dry run: %d mesh entries over %d visible card(s), each "
                 "repeated in turn", n_devices, count)
    return [torch.device("cuda", i % count) for i in range(n_devices)]


def dryrun_documents(n_devices: int):
    """The dry run's corpus: ``4 * n_devices`` short documents."""
    from modern_search_engines_project_tpu_torch.index.builder import Document

    return [
        Document(i, f"https://site{i % 5}.de/p{i}", f"title {i}",
                 f"castle river neckar museum doc{i} " * 4)
        for i in range(4 * n_devices)
    ]


def dryrun_config():
    from modern_search_engines_project_tpu_torch.config import Config

    return Config(embedding_dim=32, window_size=16, step_size=12,
                  top_k_retrieval=16, top_k_reranking=5, max_query_terms=8)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One step of each multi-device path over ``n_devices`` mesh entries
    (the module docstring).  Returns {"devices", "losses" (a), "shard"
    (b: ``search("castle museum", top_k=5)``), "dp_shard" (c:
    ``search_batch(["castle museum", "river neckar"], top_k=5)``, None
    when ``n_devices`` is odd), "encoder" (d: the same batch at top_k 3)};
    raises when a step fails its check.  The documents differ only in a
    token the analyzer drops, so the searches are smoke runs of each
    path (they return nothing, as the reference's do)."""
    from modern_search_engines_project_tpu_torch.index import IndexBuilder
    from modern_search_engines_project_tpu_torch.models import (
        HashingEncoder,
        TorchEncoder,
    )
    from modern_search_engines_project_tpu_torch.models.train import (
        TrainConfig,
        Trainer,
    )
    from modern_search_engines_project_tpu_torch.parallel.sharding import Mesh
    from modern_search_engines_project_tpu_torch.retrieval import SearchEngine

    devs = np.array(mesh_devices(n_devices, device), dtype=object)

    # (a) one dp x tp training step
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    mesh = Mesh(devs.reshape(dp, tp), ("dp", "tp"))
    tcfg = TrainConfig(batch_size=2 * dp, epochs=1, max_len=16)
    trainer = Trainer(TRAIN_CFG, tcfg, mesh=mesh).init(total_steps=1)
    triples = [
        ("castle tour", "the castle overlooks the town", 1.0),
        ("castle tour", "pizza dough recipe", 0.0),
    ] * dp
    losses = trainer.train(triples)
    if len(losses) != 1 or not all(np.isfinite(losses)):
        raise RuntimeError(f"dp x tp step: losses {losses}")

    # (b) sharded hybrid retrieval over a doc-sharded mesh
    smesh = Mesh(devs, ("shard",))
    cfg = dryrun_config()
    enc = HashingEncoder(dim=32)
    docs = dryrun_documents(n_devices)
    art = IndexBuilder(enc, cfg).build(docs)
    eng = SearchEngine.sharded(art, enc, smesh, cfg)
    res = eng.search("castle museum", top_k=5)
    if not isinstance(res, list):
        raise RuntimeError(f"sharded search: {type(res)}")

    # (c) the 2-D deployment mesh: dp replicas x doc shards
    res2 = None
    if n_devices % 2 == 0:
        mesh2d = Mesh(devs.reshape(n_devices // 2, 2), ("dp", "shard"))
        eng2 = SearchEngine.sharded(art, enc, mesh2d, cfg)
        res2 = eng2.search_batch(["castle museum", "river neckar"], top_k=5)
        if len(res2) != 2:
            raise RuntimeError(f"(dp, shard) mesh: {len(res2)} results")

    # (d) the query encoder split over the index mesh
    tenc = TorchEncoder(QUERY_CFG, generator=torch.Generator().manual_seed(1),
                        batch_size=8, device=devs[0])
    art_t = IndexBuilder(tenc, cfg).build(docs[: 2 * n_devices])
    eng_t = SearchEngine.sharded(art_t, tenc, smesh, cfg)
    if getattr(eng_t, "_sharded_enc", None) is None:
        raise RuntimeError("the sharded engine has no ShardedQueryEncoder")
    res_t = eng_t.search_batch(["castle museum", "river neckar"], top_k=3)
    if len(res_t) != 2:
        raise RuntimeError(f"sharded query encoder: {len(res_t)} results")
    return {"devices": [str(d) for d in devs], "losses": losses,
            "shard": res, "dp_shard": res2, "encoder": res_t}
