"""What a ``--trace 1`` run records: the benchmark's own spans around the
engine's calls, and a ``torch.profiler`` trace of the device over a few
seconds at the end of the window, kept in memory.

``Spans.install`` wraps methods of one engine instance (nothing of the
program changes): ``search_batch_indices`` (the data plane's batch),
``rank_batch``, ``_device_rank``, ``encode_queries`` and ``finish_batch``
(the control plane's two halves of a batch) and the cross-encoder's
``rescore``.  A batch is one record, keyed by its query list, which both
halves share; it holds the batch's wall time in engine calls, its queries,
the shapes its work is counted from, and named spans for attributing the
device's idle time.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np

from benchmark.reference import HashTokens
from benchmark.roofline import token_count


class Spans:
    def __init__(self, corpus, enc_cfg: dict):
        self.df = corpus.df
        self.tok = HashTokens(enc_cfg["vocab_size"])
        self.pool_tokens = {body: token_count(body)
                            for body in corpus.window_texts.pool}
        self.lock = threading.Lock()
        self.open: Dict[int, Dict] = {}
        self.done: List[Dict] = []
        self.spans: List[tuple] = []  # (name, t0, t1) on the monotonic clock
        self.local = threading.local()

    def _span(self, name, t0, t1):
        with self.lock:
            self.spans.append((name, t0, t1))

    def _record(self, queries) -> Dict:
        with self.lock:
            rec = self.open.get(id(queries))
            if rec is None:
                rec = self.open[id(queries)] = {
                    "n": len(queries), "t0": time.monotonic(), "wall": 0.0,
                    "queries": queries}
        return rec

    def _close(self, queries, rec):
        rec["t1"] = time.monotonic()
        with self.lock:
            self.open.pop(id(queries), None)
            del rec["queries"]
            self.done.append(rec)

    def _text_tokens(self, text: str) -> int:
        head, _, body = text.partition(" ")
        n = self.pool_tokens.get(body)
        return token_count(text) if n is None else n + 1

    def install(self, engine) -> None:
        rank_batch = engine.rank_batch
        device_rank = engine._device_rank
        encode = engine.encode_queries
        finish = engine.finish_batch
        indices = engine.search_batch_indices
        local = self.local

        def rank_batch_w(queries, *a, **k):
            rec = self._record(queries)
            local.rec = rec
            t0 = time.monotonic()
            try:
                return rank_batch(queries, *a, **k)
            finally:
                t1 = time.monotonic()
                rec["wall"] += t1 - t0
                rec["rank"] = (t0, t1)
                self._span("to_host", rec.get("dr_end", t0), t1)
                self._span("prep", t0, rec.get("enc_start", t0))

        def encode_w(texts):
            rec = getattr(local, "rec", None)
            t0 = time.monotonic()
            try:
                return encode(texts)
            finally:
                t1 = time.monotonic()
                self._span("encode", t0, t1)
                if rec is not None:
                    rec["enc_start"] = t0
                    rec["enc_tokens"] = [len(self.tok.ids(t)) + 2
                                         for t in texts[: rec["n"]]]

        def device_rank_w(term_ids, qtf, qvec):
            rec = getattr(local, "rec", None)
            t0 = time.monotonic()
            try:
                return device_rank(term_ids, qtf, qvec)
            finally:
                t1 = time.monotonic()
                self._span("device_rank", t0, t1)
                if rec is not None:
                    tids = np.asarray(term_ids)
                    u = np.unique(tids[: rec["n"]][tids[: rec["n"]] >= 0])
                    rec["postings"] = int(self.df[u].sum())
                    rec["T"] = int(tids.shape[1])
                    rec["dr_start"], rec["dr_end"] = t0, t1

        def finish_w(raw, queries, *a, **k):
            rec = self._record(queries)
            local.rec = rec
            t0 = time.monotonic()
            try:
                return finish(raw, queries, *a, **k)
            finally:
                t1 = time.monotonic()
                rec["wall"] += t1 - t0
                self._span("finish", t0, t1)
                self._close(queries, rec)

        def indices_w(queries, *a, **k):
            rec = self._record(queries)
            t0 = time.monotonic()
            try:
                return indices(queries, *a, **k)
            finally:
                t1 = time.monotonic()
                rec["wall"] = t1 - t0
                self._span("finish", rec.get("rank", (t0, t0))[1], t1)
                self._close(queries, rec)

        engine.rank_batch = rank_batch_w
        engine._device_rank = device_rank_w
        engine.encode_queries = encode_w
        engine.finish_batch = finish_w
        engine.search_batch_indices = indices_w
        ce = getattr(engine, "cross_encoder", None)
        if ce is not None:
            rescore = ce.rescore

            def rescore_w(query, texts):
                rec = getattr(local, "rec", None)
                t0 = time.monotonic()
                try:
                    return rescore(query, texts)
                finally:
                    t1 = time.monotonic()
                    self._span("stage3", t0, t1)
                    if rec is not None:
                        q = len(self.tok.ids(query))
                        rec["ce_s"] = rec.get("ce_s", 0.0) + (t1 - t0)
                        rec.setdefault("ce_tokens", []).extend(
                            min(q + 3 + self._text_tokens(t), ce.max_len)
                            for t in texts)

            ce.rescore = rescore_w

    def batches(self, t0: float, t1: float) -> List[Dict]:
        """Finished batches whose first engine call began in [t0, t1)."""
        with self.lock:
            return [b for b in self.done if t0 <= b["t0"] < t1]


class DeviceWindow:
    """A ``torch.profiler`` trace of the device's operations from
    ``start`` to ``stop``, kept in memory.  The profiler is prepared when
    this is made, so ``start`` only switches the trace on; ``stop`` keeps
    the raw events, and ``ops`` reads them, so the program's threads do
    not wait on the profiler's Python-side parsing inside the window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.prepare_trace()
        self.t0 = self.t1 = None
        self.epoch_at_t0 = None
        self.results = None

    def start(self) -> None:
        self.prof.start_trace()
        self.t0 = time.monotonic()
        self.epoch_at_t0 = time.time_ns()

    def stop(self) -> None:
        self.t1 = time.monotonic()
        self.prof.stop_trace()
        self.results = self.prof.profiler.kineto_results
        self.prof = None

    def ops(self) -> List[tuple]:
        """(name, start, end) of every device operation, in seconds of
        the monotonic clock, sorted by start."""
        from torch.autograd import DeviceType

        out = []
        for e in self.results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            a = self.t0 + (e.start_ns() - self.epoch_at_t0) / 1e9
            out.append((e.name(), a, a + e.duration_ns() / 1e9))
        out.sort(key=lambda x: x[1])
        self.results = None
        return out


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def busy_intervals(ops: List[tuple]) -> List[tuple]:
    """The union of the operations' intervals, as sorted (start, end)."""
    out: List[list] = []
    for _, a, b in ops:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def idle_by_host_span(busy: List[tuple], spans: List[tuple], t0: float,
                      t1: float) -> Dict[str, float]:
    """Seconds the device sat idle in [t0, t1), by the benchmark spans
    that were open at each gap's middle ("plane" where none was)."""
    gaps = []
    at = t0
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, t1)))
        at = max(at, b)
    if at < t1:
        gaps.append((at, t1))
    out: Dict[str, float] = {}
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        names = sorted({n for n, s, e in spans if s <= mid < e})
        key = "+".join(names) or "plane"
        out[key] = out.get(key, 0.0) + (b - a)
    return out


def kernel_totals(ops: List[tuple]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, a, b in ops:
        out[name] = out.get(name, 0.0) + (b - a)
    return out
