"""The torch port runs with no jax and imports nothing of the reference
package; its kernels are built by nvcc into a plain C library (no PyTorch
extension build)."""

import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "modern_search_engines_project_tpu_torch"
# every Python module of the port (native/, serving/, bench_kernels.py and
# the synthetic index among them), the C++ sources of the native analyzer
# and the data plane (native/http_server.cpp), and chip_smoke.py
SOURCES = (sorted(PORT.rglob("*.py")) + sorted((PORT / "native").glob("*.cpp"))
           + [ROOT / "chip_smoke.py"])
FORBIDDEN = re.compile(
    r"\bjax\b|\bflax\b|modern_search_engines_project_tpu\.|"
    r"from\s+modern_search_engines_project_tpu\s+import"
)
# neither the msgpack package nor optax nor an HTTP client or server
# outside the standard library (the checkpoint reader and writer, the
# trainers' AdamW, the assistant's client and the control plane on asyncio
# do without; the card's machine has no aiohttp)
FORBIDDEN_IMPORTS = re.compile(
    r"^\s*(import|from)\s+(msgpack|optax|httpx|aiohttp)\b")
# the one place httpx may be named: the crawler keeps the reference's
# ``HttpxTransport`` for callers who pass one, importing httpx only when
# one is built (its default transport is asyncio's; the crawler runs with
# httpx blocked below)
HTTPX_ALLOWED = (PORT / "crawler" / "fetch.py", "        import httpx")


def test_port_searches_with_jax_blocked():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None  # any import of jax now fails
        sys.modules["flax"] = None
        from modern_search_engines_project_tpu_torch.config import Config
        from modern_search_engines_project_tpu_torch.index import (
            Document, IndexBuilder)
        from modern_search_engines_project_tpu_torch.models import HashingEncoder
        from modern_search_engines_project_tpu_torch.retrieval import SearchEngine
        from modern_search_engines_project_tpu_torch import (  # noqa: F401
            bench_kernels, native, synthetic)
        abc = "abcdefghijklmnopqrstuvwxyz"
        words = [f"w{a}{b}q" for a in abc for b in abc]
        texts = [" ".join(words[(i * 13 + j * 29) % 676] for j in range(8))
                 for i in range(40)]
        docs = [Document(i, f"https://www.s{i % 5}.de/{i}", f"t{i}", t)
                for i, t in enumerate(texts)]
        cfg = Config(embedding_dim=32, window_size=32, step_size=25,
                     top_k_retrieval=20, top_k_reranking=5)
        enc = HashingEncoder(dim=32)
        art = IndexBuilder(enc, cfg).build(docs)
        for layout in ("slots", "blocked"):
            eng = SearchEngine(art, enc, cfg.replace(bm25_layout=layout),
                               device="cpu")
            res = eng.search_batch([texts[3][:10], texts[7]] * 5, top_k=5)
            assert len(res) == 10 and all(len(r) > 0 for r in res), res
            assert eng.bm25_search(texts[7]) and eng.dense_search(texts[7])
        empty = SearchEngine(IndexBuilder(enc, cfg).build([]), enc, cfg,
                             device="cpu")
        assert empty.search("castle") == []
        loaded = [m for m in sys.modules if m == "modern_search_engines_project_tpu"
                  or m.startswith("modern_search_engines_project_tpu.")]
        assert not loaded, loaded
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_encoder_loads_and_encodes_with_jax_flax_msgpack_blocked():
    """The bi-encoder's checkpoint reader needs neither the reference's
    serializer nor the msgpack package: the committed demo checkpoint
    loads and encodes, with the reference's digest."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = sys.modules["flax"] = None
        sys.modules["msgpack"] = None
        from modern_search_engines_project_tpu_torch.models import TorchEncoder
        enc = TorchEncoder.from_checkpoint("runs/encoder-demo", device="cpu")
        out = enc.encode_batch(["castle tour", "the neckar river", ""])
        assert out.shape == (3, 64), out.shape
        loaded = [m for m in sys.modules if m == "modern_search_engines_project_tpu"
                  or m.startswith("modern_search_engines_project_tpu.")]
        assert not loaded, loaded
        print(enc.params_digest())
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    from modern_search_engines_project_tpu.models.encoder import JaxEncoder

    want = JaxEncoder.from_checkpoint(str(ROOT / "runs" / "encoder-demo"))
    assert out.stdout.strip() == want.params_digest()


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_source_names_neither_jax_nor_reference_package(path):
    hits = [
        f"{i}: {line}"
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if FORBIDDEN.search(line) or (FORBIDDEN_IMPORTS.search(line)
                                      and (path, line) != HTTPX_ALLOWED)
    ]
    assert not hits, hits


def test_httpx_is_imported_only_inside_httpx_transport():
    """The exemption above holds one line, inside ``HttpxTransport``."""
    lines = HTTPX_ALLOWED[0].read_text().splitlines()
    at = [i for i, line in enumerate(lines) if "httpx" in line
          and FORBIDDEN_IMPORTS.search(line)]
    assert [lines[i] for i in at] == [HTTPX_ALLOWED[1]]
    owner = next(lines[j] for j in range(at[0], -1, -1)
                 if lines[j].startswith("class "))
    assert owner.startswith("class HttpxTransport")


def test_scan_covers_the_last_modules():
    names = ["entry.py", "eval/load_test.py", "eval/corpus.py"] + [
        f"crawler/{m}.py" for m in (
            "__init__", "__main__", "fetch", "frontier", "helpers",
            "html_parser", "main", "metric", "preprocess", "robots",
            "status_policy", "storage", "utema")]
    for name in names:
        assert PORT / name in SOURCES, name


def test_last_modules_run_with_jax_httpx_lxml_aiohttp_blocked(tmp_path):
    """The crawler, ``entry.py``, the load test and the dp x tp trainer
    import and run on the CPU with none of jax, flax, httpx, lxml and
    aiohttp importable: a crawl of an in-memory site (the stdlib parser)
    and a merge, a dp x tp step on a CPU mesh, ``entry`` at a small
    width, the device dedup, and the load test's service."""
    code = textwrap.dedent(
        f"""
        import sys
        for m in ("jax", "flax", "httpx", "lxml", "aiohttp", "msgpack",
                  "optax"):
            sys.modules[m] = None  # any import of these now fails
        import asyncio
        import numpy as np
        import torch
        from modern_search_engines_project_tpu_torch import crawler, entry
        from modern_search_engines_project_tpu_torch.crawler import (
            __main__ as crawl_cli, fetch, frontier, helpers, html_parser,
            main, metric, preprocess, robots, status_policy, storage, utema)
        from modern_search_engines_project_tpu_torch.eval import (
            corpus, load_test)
        from modern_search_engines_project_tpu_torch.models import (
            EncoderConfig, TrainConfig, Trainer)
        from modern_search_engines_project_tpu_torch.parallel.sharding import (
            Mesh)
        from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
            dedup_query_terms_device)

        class Site:
            async def get(self, url):
                if url.endswith("/robots.txt"):
                    return 200, {{}}, "User-agent: *\\nCrawl-delay: 0\\n"
                body = ("<html><head><title>T</title></head><body><main>"
                        "Tuebingen university on the Neckar. "
                        "<a href='https://u.de/b'>b</a></main></body></html>")
                return 200, {{"content-type": "text/html"}}, body

        store = crawler.CrawlStore({str(tmp_path / "c.sqlite")!r})
        c = crawler.Crawler(store, crawler.Fetcher(Site()), max_pages=3,
                            content_filter=False, expand_threshold=-1.0)
        asyncio.run(c.run(["https://u.de/a"]))
        assert store.n_documents() == 2
        merged = crawler.CrawlStore({str(tmp_path / "m.sqlite")!r})
        assert preprocess.merge_crawls(merged, store).merged == 2
        assert isinstance(crawler.Fetcher()._ensure_transport(),
                          crawler.AsyncioTransport)
        cpu = torch.device("cpu")
        mesh = Mesh(np.array([cpu] * 4, dtype=object).reshape(2, 2),
                    ("dp", "tp"))
        cfg = EncoderConfig(vocab_size=256, dim=32, n_layers=1, n_heads=2,
                            max_len=16)
        tr = Trainer(cfg, TrainConfig(batch_size=4, max_len=16), mesh=mesh)
        losses = tr.train([("a b", "c d e", 1.0), ("f", "g h", 0.0)] * 2)
        assert np.isfinite(losses).all()
        fwd, args = entry.entry(device="cpu", cfg=cfg)
        assert fwd(*args).shape == (8, 32)
        u, w = dedup_query_terms_device(torch.tensor([[3, 1, -1]]),
                                        torch.ones(1, 3), 4)
        assert u.tolist() == [1, 3, -2, -2]
        svc, vocab = load_test.build_service(30, summarize=False,
                                             device="cpu")
        assert svc.engine.art.n_docs == 30 and len(vocab) == 400
        assert isinstance(svc.engine.search(vocab[200]), list)
        loaded = [m for m in sys.modules if m == "modern_search_engines_project_tpu"
                  or m.startswith("modern_search_engines_project_tpu.")]
        assert not loaded, loaded
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_stage3_and_assistant_run_with_jax_flax_msgpack_httpx_blocked():
    """The cross-encoder, the decoder, the word vocabulary and the
    assistant import and run on the CPU with none of jax, flax, msgpack
    and httpx importable: a seeded stage 3 through the engine, a greedy
    decode, and the committed summarizer checkpoint's summary."""
    code = textwrap.dedent(
        """
        import sys
        for m in ("jax", "flax", "msgpack", "httpx"):
            sys.modules[m] = None  # any import of these now fails
        import numpy as np
        from modern_search_engines_project_tpu_torch.config import Config
        from modern_search_engines_project_tpu_torch.index import (
            Document, IndexBuilder)
        from modern_search_engines_project_tpu_torch.models import (
            CrossEncoderReranker, DecoderConfig, EncoderConfig,
            GreedyGenerator, HashingEncoder, WordVocab)
        from modern_search_engines_project_tpu_torch.models import (
            cross_encoder, decoder, word_vocab)  # noqa: F401
        from modern_search_engines_project_tpu_torch.retrieval import SearchEngine
        from modern_search_engines_project_tpu_torch.serving import (
            ExtractiveSummarizer, GenerativeSummarizer, HttpLlmClient)
        from modern_search_engines_project_tpu_torch.serving import assistant  # noqa: F401
        abc = "abcdefghijklmnopqrstuvwxyz"
        words = [f"w{a}{b}q" for a in abc for b in abc]
        texts = [" ".join(words[(i * 13 + j * 29) % 676] for j in range(8))
                 for i in range(40)]
        docs = [Document(i, f"https://www.s{i % 5}.de/{i}", f"t{i}", t)
                for i, t in enumerate(texts)]
        cfg = Config(embedding_dim=32, window_size=32, step_size=25,
                     top_k_retrieval=20, top_k_reranking=5)
        enc = HashingEncoder(dim=32)
        art = IndexBuilder(enc, cfg).build(docs)
        ce = CrossEncoderReranker(
            EncoderConfig(vocab_size=512, dim=32, n_layers=1, n_heads=2,
                          mlp_ratio=2, max_len=32), batch_size=4,
            device="cpu")
        eng = SearchEngine(art, enc, cfg, device="cpu", cross_encoder=ce)
        res = eng.search_batch([texts[3][:10], texts[7]], top_k=5)
        assert all(len(r) > 0 for r in res), res
        assert all(0 <= x.similarity_score <= 1 for r in res for x in r)
        vocab = WordVocab.build(texts)
        dcfg = DecoderConfig(vocab_size=len(vocab), dim=32, n_layers=1,
                             n_heads=2, max_len=24)
        rng = np.random.default_rng(0)
        tree = decoder.init_decoder_params(
            dcfg, lambda s: rng.standard_normal(s, dtype=np.float32))
        model = decoder.build_decoder(dcfg, tree, "cpu")
        toks = GreedyGenerator(model, device="cpu").generate([[1, 5, 2]], 6)
        assert toks.shape == (1, 6), toks.shape
        s = GenerativeSummarizer.from_checkpoint(  # a short decode
            "runs/summarizer-real", device="cpu", max_new=4)
        out = s.generate_summary("tübingen castle", [
            "Hohentübingen Castle overlooks the old town and the Neckar "
            "river. Today it houses the museum of the university."])
        assert isinstance(out, str) and out, out
        assert ExtractiveSummarizer().generate_summary("q", []) == ""
        assert HttpLlmClient("http://127.0.0.1:9/x").timeout == 30.0
        loaded = [m for m in sys.modules if m == "modern_search_engines_project_tpu"
                  or m.startswith("modern_search_engines_project_tpu.")]
        assert not loaded, loaded
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_scan_covers_the_data_plane_source():
    assert PORT / "native" / "http_server.cpp" in SOURCES
    assert PORT / "serving" / "http.py" in SOURCES


def test_scan_covers_the_parallel_package():
    for name in ("__init__.py", "sharding.py", "multihost.py"):
        assert PORT / "parallel" / name in SOURCES


def test_sharded_serving_runs_with_jax_blocked():
    """``parallel/`` imports and runs on the CPU with jax and flax not
    importable: the sharded engine on a 1-D and a (dp, shard) mesh of CPU
    shards (kernel path and scatter stage 1), the engine's scatter path,
    and the multihost module's mesh over a process layout."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None  # any import of jax now fails
        sys.modules["flax"] = None
        import numpy as np
        import torch
        from modern_search_engines_project_tpu_torch import parallel
        from modern_search_engines_project_tpu_torch.parallel import (
            multihost, sharding)
        from modern_search_engines_project_tpu_torch.config import Config
        from modern_search_engines_project_tpu_torch.index import (
            Document, IndexBuilder)
        from modern_search_engines_project_tpu_torch.models import HashingEncoder
        from modern_search_engines_project_tpu_torch.retrieval import SearchEngine
        abc = "abcdefghijklmnopqrstuvwxyz"
        words = [f"w{a}{b}q" for a in abc for b in abc]
        texts = [" ".join(words[(i * 13 + j * 29) % 676] for j in range(8))
                 for i in range(40)]
        docs = [Document(i, f"https://www.s{i % 5}.de/{i}", f"t{i}", t)
                for i, t in enumerate(texts)]
        cfg = Config(embedding_dim=32, window_size=32, step_size=25,
                     top_k_retrieval=20, top_k_reranking=5)
        enc = HashingEncoder(dim=32)
        art = IndexBuilder(enc, cfg).build(docs)
        one = SearchEngine(art, enc, cfg, device="cpu")
        want = [[r.doc_id for r in x]
                for x in one.search_batch([texts[3][:10], texts[7]], top_k=5)]
        meshes = [parallel.make_mesh(4, device="cpu"),
                  sharding.make_mesh_2d(2, 2, device="cpu")]
        for mesh in meshes:
            for up in (None, False):
                eng = SearchEngine.sharded(art, enc, mesh, cfg, use_pallas=up)
                got = [[r.doc_id for r in x] for x in eng.search_batch(
                    [texts[3][:10], texts[7]], top_k=5)]
                assert got == want, (got, want)
                assert eng.bm25_search(texts[7]) and eng.dense_search(texts[7])
        scatter = SearchEngine(art, enc, cfg, device="cpu", use_pallas=False)
        assert scatter.search(texts[7], top_k=5)
        grid = np.array([[torch.device("cpu")] * 2] * 2, dtype=object)
        mesh = multihost.make_multihost_mesh(grid, hierarchical=True)
        assert mesh.shape == {"host": 2, "shard": 2}
        loaded = [m for m in sys.modules if m == "modern_search_engines_project_tpu"
                  or m.startswith("modern_search_engines_project_tpu.")]
        assert not loaded, loaded
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_serving_runs_with_jax_and_aiohttp_blocked(tmp_path):
    """Every module of the serving slice imports with neither jax nor
    aiohttp importable, and the control plane serves one /api/search on
    the CPU from an index saved and loaded by the port."""
    code = textwrap.dedent(
        f"""
        import sys
        for m in ("jax", "flax", "aiohttp", "msgpack", "httpx"):
            sys.modules[m] = None  # any import of these now fails
        import http.client, json
        from modern_search_engines_project_tpu_torch.config import Config
        from modern_search_engines_project_tpu_torch.eval import batch
        from modern_search_engines_project_tpu_torch.index import (
            Document, IndexBuilder, artifacts, load_artifacts,
            save_artifacts)
        from modern_search_engines_project_tpu_torch.models import (
            HashingEncoder)
        from modern_search_engines_project_tpu_torch.native import (
            native_http)
        from modern_search_engines_project_tpu_torch.retrieval import (
            SearchEngine)
        from modern_search_engines_project_tpu_torch.serving import (
            SearchService, extract_domain_topic)
        from modern_search_engines_project_tpu_torch.serving import (
            api, batcher, fastpath, http as web, multiproc, rate_limiter,
            topic)
        from modern_search_engines_project_tpu_torch.serving import (
            __main__ as cli)
        from modern_search_engines_project_tpu_torch.utils import (
            device_trace)
        abc = "abcdefghijklmnopqrstuvwxyz"
        words = [f"w{{a}}{{b}}q" for a in abc for b in abc]
        texts = [" ".join(words[(i * 13 + j * 29) % 676] for j in range(8))
                 for i in range(40)]
        docs = [Document(i, f"https://www.s{{i % 5}}.de/{{i}}", f"t{{i}}", t)
                for i, t in enumerate(texts)]
        cfg = Config(embedding_dim=32, window_size=32, step_size=25,
                     top_k_retrieval=20, top_k_reranking=5)
        enc = HashingEncoder(dim=32)
        save_artifacts(IndexBuilder(enc, cfg).build(docs), {str(tmp_path)!r})
        art = load_artifacts({str(tmp_path)!r})
        eng = SearchEngine(art, enc, cfg, device="cpu", bank_dtype="int8")
        srv = web.ServerThread(SearchService(eng).build_app()).start()
        try:
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
            c.request("POST", "/api/search",
                      json.dumps({{"query": texts[7], "top_k": 3}}))
            r = c.getresponse()
            docs = json.loads(r.read())["documents"]
            assert r.status == 200 and docs[0]["doc_id"] == "7", docs
            c.close()
        finally:
            srv.stop()
        loaded = [m for m in sys.modules if m == "modern_search_engines_project_tpu"
                  or m.startswith("modern_search_engines_project_tpu.")]
        assert not loaded, loaded
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_training_and_build_run_with_jax_flax_optax_msgpack_blocked(tmp_path):
    """The offline path imports and runs on the CPU with none of jax, flax,
    optax and msgpack importable: a tiny bi-encoder trained (cosine, then
    mined hard negatives), saved and reloaded; the cross-encoder trained
    and saved; a decoder saved; an index built by ``BuildPipeline`` with
    the trained encoder and by the index CLI over a crawl store."""
    code = textwrap.dedent(
        f"""
        import sys
        for m in ("jax", "flax", "optax", "msgpack"):
            sys.modules[m] = None  # any import of these now fails
        import numpy as np
        from modern_search_engines_project_tpu_torch.crawler import CrawlStore
        from modern_search_engines_project_tpu_torch.eval import (
            encoder_quality, metrics)
        from modern_search_engines_project_tpu_torch.index import (
            BuildPipeline, Document, load_artifacts)
        from modern_search_engines_project_tpu_torch.index import (
            __main__ as index_cli)
        from modern_search_engines_project_tpu_torch.models import (
            DecoderConfig, EncoderConfig, TorchEncoder, TrainConfig, Trainer,
            init_decoder_params, load_decoder, mine_hn_triples, save_decoder,
            save_encoder, train_cross_encoder)
        from modern_search_engines_project_tpu_torch.models import (
            data, train_cli)  # noqa: F401
        pairs = data.synthetic_pairs(48)
        cfg = EncoderConfig(vocab_size=512, dim=32, n_layers=1, n_heads=2,
                            max_len=24)
        tr = Trainer(cfg, TrainConfig(batch_size=8, max_len=16),
                     device="cpu")
        losses = tr.train([(q, p, 1.0) for q, p in pairs])
        hn = mine_hn_triples(tr.to_encoder(), pairs)
        tr2 = Trainer(cfg, TrainConfig(loss="infonce_hn", batch_size=8,
                                       max_len=16), device="cpu")
        tr2.init(4, params=tr.params)
        losses += tr2.train(hn)
        assert np.isfinite(losses).all(), losses
        ck = {str(tmp_path / "enc")!r}
        save_encoder(tr2.params, cfg, ck, dtype="float16")
        enc = TorchEncoder.from_checkpoint(ck, device="cpu")
        docs = [Document(i, f"https://s{{i % 3}}.de/{{i}}", q, p)
                for i, (q, p) in enumerate(pairs[:12])]
        art = BuildPipeline(enc, {str(tmp_path / "idx")!r},
                            shard_size=5).build(docs)
        assert art.n_docs == 12 and art.encoder_meta["ckpt"] == ck
        rr, ce_losses = train_cross_encoder(
            [(q, p, 1.0) for q, p in pairs[:16]], cfg, batch_size=8,
            max_len=24, device="cpu")
        rr.save({str(tmp_path / "ce")!r})
        dcfg = DecoderConfig(vocab_size=64, dim=32, n_layers=1, n_heads=2,
                             max_len=24)
        rng = np.random.default_rng(0)
        save_decoder(init_decoder_params(
            dcfg, lambda s: rng.standard_normal(s, dtype=np.float32)),
            dcfg, {str(tmp_path / "dec")!r})
        assert load_decoder({str(tmp_path / "dec")!r}, device="cpu")[1] == dcfg
        store = CrawlStore({str(tmp_path / "crawl.sqlite")!r})
        store.upsert_documents({{"url": d.url, "title": d.title,
                                 "text": d.text}} for d in docs)
        store.close()
        index_cli.main(["--db", {str(tmp_path / "crawl.sqlite")!r},
                        "--out", {str(tmp_path / "cli")!r}, "--device",
                        "cpu", "--encoder", ck])
        assert load_artifacts({str(tmp_path / "cli")!r}).n_docs == 12
        assert metrics.mrr([3, 1], {{1}}) == 0.5
        assert encoder_quality.semantic_corpus(2, 4).n_topics == 2
        loaded = [m for m in sys.modules if m == "modern_search_engines_project_tpu"
                  or m.startswith("modern_search_engines_project_tpu.")]
        assert not loaded, loaded
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_kernels_are_plain_c_builds():
    """Route: nvcc into a shared library bound with ctypes, never PyTorch's
    extension builder or its headers."""
    for p in list(PORT.rglob("*.py")) + list((PORT / "csrc").glob("*.cu*")):
        text = p.read_text()
        assert "cpp_extension" not in text, p
        assert "torch/extension.h" not in text, p
    assert sorted(p.name for p in (PORT / "csrc").glob("*.cu")) == [
        "bm25_blocked.cu", "bm25_slots.cu", "dense_stats.cu",
    ]


def test_each_kernel_names_what_it_replaces():
    from modern_search_engines_project_tpu_torch.retrieval import (  # noqa: F401
        bm25_blocked,
        bm25_slots,
        dense_stats,
    )
    from modern_search_engines_project_tpu_torch.retrieval.cuda_lib import (
        KERNELS,
        SIGNATURES,
    )

    assert sorted(k.name for k in KERNELS) == [
        "bm25_blocked", "bm25_blocked_udedup", "bm25_slots",
        "bm25_slots_udedup_acc", "bm25_slots_udedup_i8",
        "bm25_slots_udedup_sublane", "bm25_slots_udedup_wide",
        "bm25_slots_udedup_wide_i8", "dense_stats",
    ]
    for k in KERNELS:
        assert k.symbol in SIGNATURES
        src = (ROOT / k.source).read_text()
        assert f'extern "C" int {k.symbol}(' in src
        ref_file, line = k.replaces.split(":")
        ref_src = (ROOT / ref_file).read_text().splitlines()
        assert ref_src[int(line) - 1].startswith("def _"), k.replaces
        fn = ref_src[int(line) - 1][4:].split("(")[0]
        assert fn in src, (k.name, fn)  # the source note names it
