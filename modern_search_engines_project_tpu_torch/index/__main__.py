"""Index build CLI (the upstream ``python index_all.py``).

    python -m modern_search_engines_project_tpu_torch.index \
        --db crawl.sqlite --out index_artifacts \
        [--min-score 0.0] [--shard-size 1024] [--encoder hashing|CKPT] \
        [--force] [--device cuda|cpu]

Counterpart of the reference package's ``index/__main__.py``: builds the
hybrid array index (CSR impact postings + chunk-embedding bank) from a
crawl store through ``BuildPipeline``, sharded and resumable (a re-run
skips shards already built; ``--force`` rebuilds them all).  With a
trained encoder checkpoint the windows are embedded on ``--device`` (the
card unless ``--device cpu``; with no card and no ``--device cpu`` this
exits with an error), and the artifacts record the checkpoint's path so
serving loads the matching query encoder.
"""

from __future__ import annotations

import argparse
import logging
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--db", default="crawl.sqlite")
    parser.add_argument("--out", default="index_artifacts")
    parser.add_argument("--min-score", type=float, default=0.0)
    parser.add_argument("--shard-size", type=int, default=1024)
    parser.add_argument(
        "--encoder",
        default="hashing",
        help="'hashing' or a trained encoder checkpoint dir",
    )
    parser.add_argument("--force", action="store_true",
                        help="rebuild all shards (force_reindex analog)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where a trained encoder embeds the windows")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("index")

    from modern_search_engines_project_tpu_torch.config import DEFAULT_CONFIG
    from modern_search_engines_project_tpu_torch.crawler.storage import CrawlStore
    from modern_search_engines_project_tpu_torch.index.artifacts import (
        save_artifacts,
    )
    from modern_search_engines_project_tpu_torch.index.pipeline import (
        BuildPipeline,
    )
    from modern_search_engines_project_tpu_torch.retrieval.device_index import (
        resolve_device,
    )

    device = resolve_device(args.device)
    cfg = DEFAULT_CONFIG
    if args.encoder == "hashing":
        from modern_search_engines_project_tpu_torch.models import HashingEncoder

        encoder = HashingEncoder(dim=cfg.embedding_dim)
    else:
        from modern_search_engines_project_tpu_torch.models.encoder import (
            TorchEncoder,
        )

        # from_checkpoint records ckpt_path so the artifacts' provenance
        # lets serving auto-load the matching query encoder
        encoder = TorchEncoder.from_checkpoint(args.encoder, device=device)
        cfg = cfg.replace(embedding_dim=encoder.cfg.dim)

    if args.force:
        import shutil

        shutil.rmtree(args.out, ignore_errors=True)

    store = CrawlStore(args.db)
    docs = list(store.iter_documents(min_score=args.min_score))
    log.info("building index over %d documents", len(docs))
    t0 = time.time()
    pipe = BuildPipeline(
        encoder, args.out, cfg, shard_size=args.shard_size
    )
    art = pipe.build(docs)
    save_artifacts(art, args.out)
    log.info(
        "index built in %.1fs: %s", time.time() - t0, art.index_stats()
    )


if __name__ == "__main__":
    main()
