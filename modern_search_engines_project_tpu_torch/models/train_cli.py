"""Training entry point (the upstream ``embedder_training/train.py``).

    python -m modern_search_engines_project_tpu_torch.models.train_cli \
        [--pairs pairs.tsv] [--out runs/encoder] [--epochs 1] \
        [--batch-size 256] [--device cuda|cpu]

Counterpart of the reference package's ``models/train_cli.py``, with every
flag of it plus ``--device`` (the card unless ``--device cpu``; with no
card and no ``--device cpu`` it exits with an error).  Without --pairs it
trains on deterministic synthetic pairs (air-gapped default).  Hard
negatives are mined with the untrained encoder, labels are binary, the
loss is CosineSimilarityLoss, the optimizer AdamW with 10% linear warmup.
``--dp N [--tp M]`` trains on a (dp, tp) mesh over the first N * M visible
cards (``models/train.py``'s dp x tp step), or N * M CPU entries with
``--device cpu``; with fewer cards visible it exits non-zero, naming the
count.
"""

from __future__ import annotations

import argparse
import logging
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pairs", default=None, help="TSV query\\tpassage")
    parser.add_argument("--limit", type=int, default=10_000)
    parser.add_argument("--out", default="runs/encoder")
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--lr", type=float, default=2e-5)
    parser.add_argument("--negatives", type=int, default=5)
    parser.add_argument("--max-len", type=int, default=128)
    parser.add_argument("--dim", type=int, default=768)
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--dp", type=int, default=0, help="data-parallel axis")
    parser.add_argument("--tp", type=int, default=1, help="tensor-parallel axis")
    parser.add_argument("--synthetic", type=int, default=2048)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    mesh = None
    if args.dp:
        mesh = _mesh(parser, args.dp, args.tp, args.device)

    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("train")

    from modern_search_engines_project_tpu_torch.models.checkpoint import (
        save_encoder,
    )
    from modern_search_engines_project_tpu_torch.models.data import (
        load_pairs_tsv,
        make_triples,
        synthetic_pairs,
    )
    from modern_search_engines_project_tpu_torch.models.encoder import (
        EncoderConfig,
        TorchEncoder,
    )
    from modern_search_engines_project_tpu_torch.models.train import (
        TrainConfig,
        Trainer,
    )
    from modern_search_engines_project_tpu_torch.retrieval.device_index import (
        resolve_device,
    )

    device = mesh.devices[0, 0] if mesh is not None else resolve_device(
        args.device)
    pairs = (
        load_pairs_tsv(args.pairs, args.limit)
        if args.pairs
        else synthetic_pairs(args.synthetic)
    )
    log.info("loaded %d pairs", len(pairs))

    enc_cfg = EncoderConfig(
        dim=args.dim,
        n_layers=args.layers,
        n_heads=max(1, args.dim // 64),
        max_len=512,
    )
    mining_encoder = TorchEncoder(enc_cfg, max_len=args.max_len, device=device)
    t0 = time.time()
    triples = make_triples(pairs, mining_encoder, num_negatives=args.negatives)
    log.info("mined %d triples in %.1fs", len(triples), time.time() - t0)
    del mining_encoder

    tcfg = TrainConfig(
        learning_rate=args.lr,
        batch_size=args.batch_size,
        epochs=args.epochs,
        num_negatives=args.negatives,
        max_len=args.max_len,
    )
    if mesh is not None:
        log.info("mesh: dp=%d tp=%d on %s", args.dp, args.tp,
                 ", ".join(str(d) for d in mesh.devices.reshape(-1)))
    trainer = Trainer(enc_cfg, tcfg, mesh=mesh, device=device)
    t0 = time.time()
    losses = trainer.train(triples)
    log.info(
        "trained %d steps in %.1fs: loss %.4f -> %.4f",
        len(losses), time.time() - t0, losses[0], losses[-1],
    )
    save_encoder(trainer.params, enc_cfg, args.out)
    log.info("saved encoder to %s", args.out)


def _mesh(parser, dp: int, tp: int, device: str):
    """The (dp, tp) mesh over the first dp * tp visible cards (CPU entries
    with ``device="cpu"``); exits through ``parser.error`` when fewer
    cards are visible."""
    import numpy as np
    import torch

    from modern_search_engines_project_tpu_torch.parallel.sharding import Mesh

    n = dp * tp
    if device == "cpu":
        devs = [torch.device("cpu")] * n
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            parser.error(f"--dp {dp} --tp {tp} needs {n} visible CUDA "
                         f"devices, {count} visible")
        devs = [torch.device("cuda", i) for i in range(n)]
    return Mesh(np.array(devs, dtype=object).reshape(dp, tp), ("dp", "tp"))


if __name__ == "__main__":
    main()
