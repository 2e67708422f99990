"""CLI: serve a built index over HTTP on the torch engine.

    python -m modern_search_engines_project_tpu_torch.serving \\
        --index /path/to/artifacts [--port 5000] [--device cuda|cpu]

Counterpart of the reference package's ``serving/__main__.py``.  Builds a
demo index from bundled sample documents when --index is omitted, so the
UI can be driven end to end without a crawl.  The engine runs on the card
(``--device cuda``, the default; it raises without one) unless
``--device cpu`` asks for the plain PyTorch versions on the CPU.
``--sharded`` shards the index over every visible card (one CPU shard
with ``--device cpu``); ``--mesh DP,SHARD`` over a (dp, shard) mesh of
DP x SHARD cards (CPU shards with ``--device cpu``), exiting non-zero when
fewer cards are visible.
"""

from __future__ import annotations

import argparse
import logging


def _demo_artifacts(cfg):
    from modern_search_engines_project_tpu_torch.index import (
        Document,
        IndexBuilder,
    )
    from modern_search_engines_project_tpu_torch.models import HashingEncoder

    docs = [
        Document(1, "https://www.tuebingen.de/en/schloss",
                 "Hohentübingen Castle",
                 "The castle of Tuebingen overlooks the Neckar river and the "
                 "old town. The university museum of ancient cultures is "
                 "inside the castle walls. " * 12),
        Document(2, "https://uni-tuebingen.de/en/",
                 "University of Tübingen",
                 "The Eberhard Karls University of Tuebingen is one of the "
                 "oldest universities in Germany, known for philosophy, "
                 "medicine, theology and machine learning research. " * 12),
        Document(3, "https://www.stocherkahn.de/race",
                 "Stocherkahn punting race",
                 "Punt boats race on the Neckar every June, a Tuebingen "
                 "student tradition with decorated boats and crowds on the "
                 "Neckar bridge. " * 10),
        Document(4, "https://www.tuebingen-info.de/en/chocolart",
                 "ChocolART festival",
                 "ChocolART is Germany's biggest chocolate festival held in "
                 "the old town of Tuebingen every December with chocolatiers "
                 "from around the world. " * 10),
        Document(5, "https://cyber-valley.de/en/",
                 "Cyber Valley",
                 "Cyber Valley is Europe's largest research consortium for "
                 "artificial intelligence with the Max Planck Institute and "
                 "the University of Tuebingen. " * 10),
        # docs without the anchor city term keep its document frequency
        # below N/2: in a tiny all-Tübingen corpus its idf goes negative
        # and (faithfully to the reference's min_score=0 rule) every
        # augmented query returns nothing
        Document(6, "https://www.example.com/pizza",
                 "Pizza dough basics",
                 "How to make pizza dough with yeast, flour, salt and time. "
                 * 10),
        Document(7, "https://www.example.com/cycling",
                 "Cycling guide",
                 "Road cycling training plans for beginners and commuters. "
                 * 10),
        Document(8, "https://www.example.com/coffee",
                 "Coffee brewing",
                 "Pour over coffee brewing ratios and grinder settings. " * 10),
        Document(9, "https://www.example.com/garden",
                 "Garden tips",
                 "Vegetable garden planning for small urban balconies. " * 10),
        Document(10, "https://www.example.com/chess",
                 "Chess openings",
                 "An overview of classical chess openings for club players. "
                 * 10),
        Document(11, "https://www.example.com/hiking",
                 "Hiking checklist",
                 "A packing checklist for multi day hiking trips in the alps. "
                 * 10),
    ]
    enc = HashingEncoder(dim=cfg.embedding_dim)
    return IndexBuilder(enc, cfg).build(docs), enc


def resolve_encoder(art, ckpt=None, force=False, device=None):
    """Build the query encoder matching the index's embedding provenance.

    An index embedded with the trained bi-encoder (``encoder_meta`` kind
    "jax_biencoder", written by either package) must never silently get
    queries encoded by a fresh ``HashingEncoder``: the spaces differ and
    the dense stage degrades to noise.  Such an index is served by
    ``TorchEncoder``, which records the same params digest; a mismatch is
    refused unless ``force``."""
    from modern_search_engines_project_tpu_torch.models import (
        HashingEncoder,
        TorchEncoder,
    )

    meta = getattr(art, "encoder_meta", {}) or {}
    kind = meta.get("kind")
    if ckpt:
        enc = TorchEncoder.from_checkpoint(ckpt, device=device)
        if not force:
            if kind == "hashing":
                raise SystemExit(
                    "index was embedded with a HashingEncoder but "
                    "--encoder-ckpt was given; pass --force-encoder to "
                    "override"
                )
            want = meta.get("params_digest")
            if want and enc.params_digest() != want:
                raise SystemExit(
                    f"encoder checkpoint digest {enc.params_digest()} does "
                    f"not match the index's recorded digest {want}; the "
                    "query/chunk embedding spaces would differ.  Pass "
                    "--force-encoder to override."
                )
        return enc
    if kind == "jax_biencoder":
        recorded = meta.get("ckpt")
        import os

        if recorded and os.path.isdir(recorded):
            enc = TorchEncoder.from_checkpoint(recorded, device=device)
            want = meta.get("params_digest")
            if want and enc.params_digest() != want and not force:
                raise SystemExit(
                    f"checkpoint at recorded path {recorded} no longer "
                    "matches the index's params digest; pass --encoder-ckpt "
                    "or --force-encoder"
                )
            return enc
        if not force:
            raise SystemExit(
                "index was embedded with a trained bi-encoder but no "
                "checkpoint is reachable; pass --encoder-ckpt (or "
                "--force-encoder to serve with a hashing encoder anyway)"
            )
    # hashing provenance (or legacy index with none recorded)
    return HashingEncoder(
        dim=meta.get("dim", art.config.embedding_dim),
        vocab_size=meta.get("vocab_size", art.config.vocab_size),
        seed=meta.get("seed", 0),
    )


def build_engine_from_args(args):
    """Engine factory shared by the in-line server and the worker
    processes (module level: worker processes import it after spawn)."""
    from modern_search_engines_project_tpu_torch.config import DEFAULT_CONFIG
    from modern_search_engines_project_tpu_torch.retrieval import SearchEngine

    if args.index:
        from modern_search_engines_project_tpu_torch.index import (
            load_artifacts,
        )

        art = load_artifacts(args.index)
        enc = resolve_encoder(art, args.encoder_ckpt, args.force_encoder,
                              args.device)
        cfg = art.config
    else:
        cfg = DEFAULT_CONFIG
        art, enc = _demo_artifacts(cfg)
    bank = "int8" if args.int8_bank else None
    if args.mesh or args.sharded:
        from modern_search_engines_project_tpu_torch.parallel.sharding import (
            make_mesh,
            make_mesh_2d,
        )

        if args.mesh:
            dp, shard = (int(x) for x in args.mesh.split(","))
            mesh = make_mesh_2d(dp, shard, device=args.device)
        else:
            mesh = make_mesh(device=args.device)
        logging.info("sharded engine: %s mesh %s on %s", mesh.axis_names,
                     tuple(mesh.devices.shape),
                     sorted({str(d) for d in mesh.devices.flat}))
        return SearchEngine.sharded(art, enc, mesh, cfg, bank_dtype=bank)
    return SearchEngine(art, enc, cfg, bank_dtype=bank, device=args.device)


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--index", default=None, help="artifacts directory")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="run the engine on the card (default; raises "
                             "without one) or on the CPU with the plain "
                             "PyTorch versions of the kernels")
    parser.add_argument("--sharded", action="store_true",
                        help="shard the index over every visible card (one "
                             "CPU shard with --device cpu)")
    parser.add_argument("--mesh", default=None, metavar="DP,SHARD",
                        help="2-D deployment mesh: DP index replicas x SHARD "
                             "document shards, one card each (CPU shards "
                             "with --device cpu)")
    parser.add_argument("--queries", default="queries.txt")
    parser.add_argument("--encoder-ckpt", default=None,
                        help="trained encoder checkpoint dir (config.json + "
                             "params.msgpack)")
    parser.add_argument("--force-encoder", action="store_true",
                        help="serve even if the encoder does not match the "
                             "index's embedding provenance")
    parser.add_argument("--int8-bank", action="store_true",
                        help="serve the dense chunk bank int8-quantized per "
                             "row (half the device memory of bf16; an s32 "
                             "library product in place of the stats kernel)")
    parser.add_argument("--summarizer-ckpt", default=None,
                        help="trained generative-summary decoder dir: "
                             "/api/generate_summary and the search "
                             "response's llm_response become model-"
                             "generated text (default: extractive backend)")
    parser.add_argument("--query-cache", type=int, default=1024,
                        help="LRU size for (query, top_k) result caching "
                             "(0 disables; cleared on /api/reload)")
    parser.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="run the hot query shapes once before serving "
                             "(builds the kernels, warms the allocator; "
                             "--no-warmup for fast dev restarts)")
    parser.add_argument("--admin-token", default=None,
                        help="require X-Admin-Token on /api/reload and "
                             "/api/profile (default: open)")
    parser.add_argument("--trace-root", default="/tmp/msetpu_profile",
                        help="directory torch.profiler traces land under "
                             "(clients pick a label, never a path)")
    parser.add_argument("--fastpath-port", type=int, default=None,
                        help="also serve POST /api/search + /api/health on "
                             "this port through the C++ epoll data plane "
                             "(native/http_server.cpp)")
    parser.add_argument("--fastpath-pipeline", type=int, default=2,
                        help="concurrent native dispatcher threads: depth "
                             "D keeps D device batches in flight (the rank "
                             "callback's device wait releases the GIL)")
    parser.add_argument("--fastpath-threads", type=int, default=1,
                        help="event-loop threads for the native data plane")
    parser.add_argument("--workers", type=int, default=0,
                        help="run N worker processes sharing the port via "
                             "SO_REUSEPORT (serving/multiproc.py), each "
                             "with its own engine; 0 = single process")
    return parser


def main():
    args = make_parser().parse_args()

    logging.basicConfig(level=logging.INFO)
    from modern_search_engines_project_tpu_torch.serving.api import (
        SearchService,
    )

    def build_engine():
        return build_engine_from_args(args)

    if args.workers > 0:
        from modern_search_engines_project_tpu_torch.serving.multiproc import (
            serve_workers,
        )

        serve_workers(args)
        return

    engine = build_engine()
    if args.warmup:
        import time as _time

        t0 = _time.time()
        n = engine.warmup()
        logging.info(
            "warmed %d query shapes in %.1fs", n, _time.time() - t0
        )

    summarizer = None
    if args.summarizer_ckpt:
        from modern_search_engines_project_tpu_torch.serving.assistant import (
            GenerativeSummarizer,
        )

        summarizer = GenerativeSummarizer.from_checkpoint(
            args.summarizer_ckpt, device=args.device
        )
        logging.info(
            "generative summarizer loaded from %s", args.summarizer_ckpt
        )

    service = SearchService(
        engine,
        summarizer=summarizer,
        queries_path=args.queries,
        query_cache_size=args.query_cache,
        # reload re-reads the index dir; the demo corpus is deterministic,
        # so reloading it is harmless (and keeps the endpoint testable)
        engine_factory=build_engine,
        trace_root=args.trace_root,
        admin_token=args.admin_token,
    )
    fast = None
    if args.fastpath_port:
        from modern_search_engines_project_tpu_torch.serving.fastpath import (
            attach_engine,
            serve_fastpath,
        )

        fast = serve_fastpath(
            engine, args.fastpath_port, n_threads=args.fastpath_threads,
            pipeline=args.fastpath_pipeline,
        )
        # /api/reload swaps the control-plane engine; the data plane must
        # follow (fragments + rank callback) or it serves the stale index
        service.reload_listeners.append(
            lambda eng, _f=fast: attach_engine(_f, eng)
        )
    try:
        service.run(host=args.host, port=args.port)
    finally:
        if fast is not None:
            fast.stop()


if __name__ == "__main__":
    main()
