"""The system under test: the port's engine behind the plane a
configuration names, started as the serving CLI starts it
(``serving/__main__.py``), with the program's defaults.

  * "data": the C++ data plane, ``serving.fastpath.serve_fastpath`` at the
    CLI's defaults (``--fastpath-pipeline 2``, ``--fastpath-threads 1``),
    which calls ``engine.search_batch_indices`` a batch.
  * "control": ``serving.api.SearchService`` (its ``QueryBatcher``, its
    query cache at the CLI's ``--query-cache`` default of 1024, the
    extractive summarizer) on ``serving/http.py``, served from a thread.

The CLI has no switch for stage 3, so the engine is built here with the
cross-encoder where the configuration has one; everything else is what
``build_engine_from_args`` builds for an index without ``--int8-bank``.
"""

from __future__ import annotations

import json
import socket
import time
import urllib.request
from typing import Dict, List

import numpy as np

from benchmark.corpus import DOC_ID_BASE, Corpus


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def artifacts(corpus: Corpus, engine_cfg: Dict):
    """The program's ``IndexArtifacts`` over the corpus arrays (read-only,
    shared, not copied) and the configuration's result-defining knobs."""
    from modern_search_engines_project_tpu_torch.config import Config
    from modern_search_engines_project_tpu_torch.index import IndexArtifacts
    from modern_search_engines_project_tpu_torch.index.vocab import (
        TermDictionary,
    )

    n = corpus.n_docs
    df = corpus.df
    return IndexArtifacts(
        indptr=corpus.indptr,
        post_docs=corpus.post_docs,
        post_impact=corpus.post_impact,
        idf=np.log((n - df + 0.5) / (df + 0.5)).astype(np.float32),
        df=df,
        doc_len=corpus.doc_len,
        avgdl=float(corpus.doc_len.mean()),
        chunk_emb=corpus.chunk_emb,
        chunk_doc=corpus.chunk_doc,
        doc_chunk_start=corpus.doc_chunk_start,
        doc_n_chunks=corpus.doc_n_chunks,
        vocab=TermDictionary({w: i for i, w in enumerate(corpus.words)}),
        doc_ids=list(range(DOC_ID_BASE, DOC_ID_BASE + n)),
        urls=corpus.urls,
        titles=corpus.titles,
        domains=corpus.domains,
        snippets=corpus.snippets,
        window_texts=corpus.window_texts,
        config=Config(**engine_cfg),
    )


class Program:
    """The engine and its plane; ``counters()`` reads the plane's and the
    engine's counters, ``stop()`` ends the plane."""

    def __init__(self, cfg: Dict, corpus: Corpus, enc_params, ce_params,
                 device, bank_dtype=None):
        from modern_search_engines_project_tpu_torch.models import (
            CrossEncoderReranker,
            EncoderConfig,
            TorchEncoder,
        )
        from modern_search_engines_project_tpu_torch.retrieval import (
            SearchEngine,
        )

        art = artifacts(corpus, cfg["engine"])
        enc = TorchEncoder(EncoderConfig(**cfg["encoder"]), params=enc_params,
                           device=device)
        ce = None
        if ce_params is not None:
            ce = CrossEncoderReranker(EncoderConfig(**cfg["cross_encoder"]),
                                      params=ce_params, device=device)
        self.engine = SearchEngine(art, enc, art.config, bank_dtype=bank_dtype,
                                   device=device, cross_encoder=ce)
        self.kind = cfg["plane"]
        self.port = free_port()
        self.fast = self.service = self.thread = None

    def start(self) -> None:
        if self.kind == "data":
            from modern_search_engines_project_tpu_torch.serving.fastpath import (
                serve_fastpath,
            )

            self.fast = serve_fastpath(self.engine, self.port)
        else:
            from modern_search_engines_project_tpu_torch.serving.api import (
                SearchService,
            )
            from modern_search_engines_project_tpu_torch.serving.http import (
                ServerThread,
            )

            self.service = SearchService(self.engine, query_cache_size=1024)
            self.thread = ServerThread(self.service.build_app(), "127.0.0.1",
                                       self.port).start()

    def warm(self, batches: List[List[str]]) -> None:
        """Run the cell's own batch shapes through the engine as the plane
        calls it, then a few requests through the plane itself."""
        eng = self.engine
        for qs in batches:
            if self.kind == "data":
                eng.search_batch_indices(qs)
            else:
                eng.finish_batch(eng.rank_batch(qs), qs)
        for q in batches[-1][:3]:
            req = urllib.request.Request(
                f"http://127.0.0.1:{self.port}/api/search",
                data=json.dumps({"query": q}).encode(),
                headers={"Content-Type": "application/json"})
            opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
            with opener.open(req, timeout=120) as r:
                if r.status != 200:
                    raise RuntimeError(f"warm-up request: HTTP {r.status}")
                r.read()

    def banks_not_of(self, dtype: str) -> int:
        """How many of the engine's dense banks are not of ``dtype`` (a
        torch dtype's name); an int8 bank, a pair of codes and scales, is
        never of it."""
        import torch

        want = getattr(torch, dtype)
        di = self.engine.didx
        banks = list(di.bucket_emb) + ([di.chunk_emb]
                                      if di.chunk_emb is not None else [])
        return sum(1 for b in banks
                   if not isinstance(b, torch.Tensor) or b.dtype != want)

    def counters(self) -> Dict:
        """The plane's queries and device batches, and the engine's
        stage totals (seconds) and counts, at this moment."""
        if self.fast is not None:
            st = self.fast.stats()
            plane = {"queries": st["batched_queries"], "batches": st["batches"]}
        else:
            b = self.service.batcher
            plane = {"queries": b.requests, "batches": b.device_batches}
        stages = {k: (v["total_s"], v["count"])
                  for k, v in self.engine.times.report().items()}
        return {"at": time.monotonic(), "plane": plane, "stages": stages}

    def stop(self) -> None:
        if self.fast is not None:
            self.fast.stop()
        if self.thread is not None:
            self.thread.stop()
