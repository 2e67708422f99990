"""The port's spans and counters (``utils/timing.StageTimes``,
``stage_timer``) and the stages the engine and the encoder record with
them, on the CPU."""

import copy
import threading
import time

import pytest

from corpus_util import make_corpus
from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.index import IndexBuilder
from modern_search_engines_project_tpu_torch.models import (
    EncoderConfig,
    TorchEncoder,
)
from modern_search_engines_project_tpu_torch.retrieval import SearchEngine
from modern_search_engines_project_tpu_torch.utils.timing import (
    StageTimes,
    inner_record,
    inner_timer,
    stage_timer,
)

CFG = dict(embedding_dim=32, window_size=32, step_size=25,
           top_k_retrieval=20, top_k_reranking=10, max_query_terms=8)
QUERIES = ["research law", "neckar river castle", "law", "faculty tour",
           "garden square", "ai research", "river", "castle law", "tour",
           "square law"]


def test_spans_are_on_the_monotonic_clock():
    times = StageTimes()
    times.keep_spans(8)
    a = time.monotonic_ns()
    with stage_timer("outer", times):
        time.sleep(0.002)
    b = time.monotonic_ns()
    (name, parent, ident, batch, t0, t1), = times.spans()
    assert (name, parent, ident, batch) == ("outer", None,
                                            threading.get_ident(), None)
    assert a <= t0 < t1 <= b and t1 - t0 >= 2_000_000


def test_child_records_its_parent_and_batch():
    times = StageTimes()
    times.keep_spans(8)
    bid = times.begin_batch()
    with stage_timer("outer", times):
        with stage_timer("inner", times):
            pass
    with stage_timer("after", times):
        pass
    got = {s[0]: (s[1], s[3]) for s in times.spans()}
    assert got == {"outer": (None, bid), "inner": ("outer", bid),
                   "after": (None, bid)}
    assert times.begin_batch() == bid + 1
    other = StageTimes()  # a batch id belongs to its registry
    other.keep_spans(8)
    with stage_timer("elsewhere", other):
        pass
    assert other.spans()[0][3] is None


def test_cpu_within_wall_and_offcpu_grows_across_a_wait():
    times = StageTimes()
    with stage_timer("busy", times):
        sum(range(200_000))
    for _ in range(3):
        with stage_timer("wait", times):
            time.sleep(0.01)
    r = times.report()
    for stage in ("busy", "wait"):
        e = r[stage]
        assert 0 <= e["cpu_ms"] <= e["mean_ms"] + 1e-3
        assert e["offcpu_ms"] == pytest.approx(e["mean_ms"] - e["cpu_ms"],
                                               abs=2e-3)
    assert r["wait"]["offcpu_ms"] >= 9.0  # each sleep gives the CPU up
    assert r["wait.offcpu"]["count"] == 3
    assert r["wait.offcpu"]["total_s"] == pytest.approx(
        3 * r["wait"]["offcpu_ms"] / 1e3, abs=1e-3)


def test_span_record_off_by_default_and_bounded():
    times = StageTimes()
    with stage_timer("a", times):
        pass
    assert times.spans() == [] and times._spans is None
    times.keep_spans(4)
    for i in range(10):
        with stage_timer(f"s{i}", times):
            pass
    assert [s[0] for s in times.spans()] == ["s6", "s7", "s8", "s9"]
    times.keep_spans(0)
    with stage_timer("b", times):
        pass
    assert times.spans() == []
    assert times.report()["a"]["count"] == 1


def test_span_record_is_thread_safe():
    times = StageTimes()
    times.keep_spans(100_000)
    n = 2_000
    idents = {}

    def work(tag):
        idents[tag] = threading.get_ident()
        times.begin_batch()
        for _ in range(n):
            with stage_timer(f"outer_{tag}", times):
                with stage_timer(f"inner_{tag}", times):
                    pass

    ts = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    spans = times.spans()
    assert len(spans) == 4 * n
    batches = {}
    for name, parent, ident, batch, t0, t1 in spans:
        tag = name[-1]
        assert ident == idents[tag] and t0 <= t1
        assert parent == (f"outer_{tag}" if name.startswith("inner") else None)
        batches.setdefault(tag, set()).add(batch)
    assert sorted(b for s in batches.values() for b in s) == [1, 2]
    r = times.report()
    assert all(r[f"{k}_{t}"]["count"] == n
               for k in ("outer", "inner") for t in "ab")


def test_report_keeps_its_keys_and_takes_counters():
    times = StageTimes()
    with stage_timer("stage", times):
        pass
    times.record("counter", 0.5)
    times.record("counter", 0.25)
    times.add_source("ext", lambda: {"ext_wait": (2.0, 8)})
    r = times.report()
    assert {"total_s", "count", "mean_ms"} <= set(r["stage"])
    assert r["counter"] == {"total_s": 0.75, "count": 2, "mean_ms": 375.0}
    assert r["ext_wait"] == {"total_s": 2.0, "count": 8, "mean_ms": 250.0}
    assert set(r) == {"stage", "stage.offcpu", "counter", "ext_wait"}


def test_inner_timer_records_into_the_enclosing_registry():
    outer, other = StageTimes(), StageTimes()
    with inner_timer("alone"):  # no span open: nothing recorded
        pass
    with stage_timer("outer", outer):
        with inner_timer("inner"):
            pass
    with stage_timer("other", other):
        with inner_timer("inner"):
            with inner_timer("innermost"):
                pass
    assert set(outer.report()) == {"outer", "outer.offcpu", "inner",
                                   "inner.offcpu"}
    assert other.report()["innermost"]["count"] == 1
    assert other.report()["inner"]["count"] == 1


def test_inner_record_counts_into_the_innermost_registry():
    """A counter recorded with no span open goes nowhere; inside spans of
    two registries it lands in the innermost span's, with no off-CPU
    entry (a counter has no CPU time)."""
    outer, inner = StageTimes(), StageTimes()
    inner_record("alone", 1.0)
    with stage_timer("outer", outer):
        with stage_timer("inner", inner):
            inner_record("replay", 0.25)
            inner_record("replay", 0.5)
        inner_record("after", 0.125)
    r = inner.report()
    assert r["replay"] == {"total_s": 0.75, "count": 2, "mean_ms": 375.0}
    assert "replay.offcpu" not in r and "after" not in r
    assert outer.report()["after"]["count"] == 1
    assert "alone" not in outer.report() and "alone" not in r


@pytest.fixture(scope="module")
def engine():
    docs = make_corpus(n_docs=40, seed=3, min_len=40, max_len=120)
    enc = TorchEncoder(EncoderConfig(vocab_size=512, dim=32, n_layers=1,
                                     n_heads=2, mlp_ratio=2, max_len=32,
                                     dtype="float32"), device="cpu")
    return SearchEngine(IndexBuilder(enc, Config(**CFG)).build(docs), enc,
                        Config(**CFG), device="cpu")


def _batch_spans(eng, queries, qbs):
    eng.cfg = eng.cfg.replace(query_batch_size=qbs)
    eng.times = StageTimes()
    eng.times.keep_spans(1000)
    eng.search_batch_indices(queries)
    return eng.times.spans()


@pytest.mark.parametrize("qbs", [64, 4])
def test_engine_stages_nest_one_rank_a_batch(engine, qbs):
    """One span of each engine stage a batch, on the one-chunk branch and
    the chunked one (10 queries in chunks of 4); the rank splits into its
    enqueue and its wait, the encode into tokens and forward."""
    spans = _batch_spans(engine, QUERIES, qbs)
    parent = {s[0]: s[1] for s in spans}
    names = [s[0] for s in spans]
    for stage in ("query_prep", "query_encode", "device_rank",
                  "rank_enqueue", "rank_wait", "finish_indices"):
        assert names.count(stage) == 1, (stage, names)
    chunks = -(-len(QUERIES) // qbs)
    assert names.count("encode_tokens") == names.count("encode_forward") == chunks
    assert parent["rank_enqueue"] == parent["rank_wait"] == "device_rank"
    assert parent["encode_tokens"] == parent["encode_forward"] == "query_encode"
    assert parent["device_rank"] is None
    assert len({s[3] for s in spans}) == 1  # one batch id
    by = {s[0]: s for s in spans}
    assert by["rank_enqueue"][5] <= by["rank_wait"][4]
    assert by["device_rank"][4] <= by["rank_enqueue"][4]
    assert by["rank_wait"][5] <= by["device_rank"][5]


def test_engine_hands_its_times_to_the_encoder(engine):
    """The encoder's spans land in the registry of the engine calling it,
    also when two engines share the encoder and one registry is replaced."""
    twin = copy.copy(engine)
    twin.times = StageTimes()
    fresh = StageTimes()
    engine.times = fresh
    engine.search_batch(QUERIES[:2])
    r = fresh.report()
    assert r["encode_tokens"]["count"] == r["encode_forward"]["count"] == 1
    assert "encode_graph" not in r  # the CPU runs the forward eagerly
    assert r["device_rank"]["count"] == 1
    twin.search_batch(QUERIES[:2])
    twin.search_batch(QUERIES[:3])
    assert fresh.report()["encode_forward"]["count"] == 1
    assert twin.times.report()["encode_forward"]["count"] == 2
