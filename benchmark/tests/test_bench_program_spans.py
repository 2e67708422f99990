"""The metrics read from the program's own spans and counters, on the CPU
at a tiny size, and the attribution of idle device time by the program's
spans."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark import cells, program_spans, run
from benchmark.tests import tiny

SEED = 3_000_000_019

NEW = {"open": ("plane.queue_ms", "plane.host_ms", "rank.enqueue_ms",
                "rank.wait_ms", "engine.offcpu_pct"),
       "closed": ("plane.queue_ms.sat", "plane.copy_ms.sat",
                  "engine.offcpu_pct.sat")}


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_new_readers_read_a_number_in_a_traced_run(loop):
    r = run.run_cell(tiny.cell("data", loop), SEED, 2.0, True, device="cpu",
                     t_start=time.monotonic())
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    for name in NEW[loop]:
        assert isinstance(got.get(name), float), (name, got)
    if loop == "open":
        assert 0.0 <= got["engine.offcpu_pct"] <= 100.0
        assert got["plane.host_ms"] >= got["plane.queue_ms"] > 0.0


def test_untraced_result_keeps_its_keys():
    r = run.run_cell(tiny.cell("data", "open"), SEED, 2.0, False,
                     device="cpu", t_start=time.monotonic())
    assert set(r) == {"correct", "attempted", "failed", "metrics", "device",
                      "checks", "_cores", "_host", "_setup", "_failures",
                      "_lateness_ms", "_latency_ms"}
    assert set(r["metrics"]) == {m["name"] for m in cells.spec()["end_to_end"]}


def test_readers_read_nothing_where_the_program_records_nothing():
    """A program without the new spans and counters (the parent's) gives
    no number, and no reader raises."""
    stages = {"query_prep": (1.0, 10), "device_rank": (2.0, 10),
              "finish_indices": (0.5, 10)}
    ctx = SimpleNamespace(c0={"stages": {}}, c1={"stages": stages})
    spec = cells.spec()
    for loop, names in NEW.items():
        for name in names:
            entry = next(m for m in spec["per_layer"] if m["name"] == name)
            assert cells.reader(entry).read(ctx) is None, name


def test_offcpu_over_the_leaf_spans():
    c0 = {"stages": {"query_prep": (1.0, 10), "query_prep.offcpu": (0.5, 10),
                     "device_rank": (3.0, 10)}}
    c1 = {"stages": {"query_prep": (2.0, 20), "query_prep.offcpu": (0.75, 20),
                     "encode_forward": (3.0, 10),
                     "encode_forward.offcpu": (2.25, 10),
                     "device_rank": (6.0, 20)}}
    ctx = SimpleNamespace(c0=c0, c1=c1)
    assert program_spans.offcpu_pct(ctx) == pytest.approx(100 * 2.5 / 4.0)


def _span(name, parent, ident, a, b):
    return (name, parent, ident, 1, int(a * 1e9), int(b * 1e9))


def test_idle_gaps_go_to_the_innermost_span_of_each_thread():
    spans = [
        _span("encode_forward", "query_encode", 1, 1.0, 3.0),
        _span("query_encode", None, 1, 0.5, 3.5),
        _span("rank_wait", "device_rank", 2, 2.0, 5.0),
        _span("device_rank", None, 2, 1.5, 5.5),
    ]
    busy = [(0.0, 0.2), (0.8, 1.2), (2.6, 2.8), (4.0, 4.2), (5.9, 6.0)]
    got = program_spans.idle_by_program_span(busy, spans, 0.0, 6.0)
    want = {
        "query_encode": 0.6,                      # gap 0.2-0.8, mid 0.5
        "device_rank+encode_forward": 1.4,        # 1.2-2.6, mid 1.9
        "query_encode+rank_wait": 1.2,            # 2.8-4.0, mid 3.4
        "device_rank": 1.7,                       # 4.2-5.9, mid 5.05
    }
    assert set(got) == set(want)
    for k, v in got.items():
        assert v == pytest.approx(want[k])
    assert program_spans.idle_by_program_span(busy, [], 0.0, 6.0) == {
        "plane": pytest.approx(4.9)}


def test_span_cost_is_measured_off_and_on():
    cost = program_spans.span_cost_ns(2000)
    assert set(cost) == {"off", "on"} and min(cost.values()) > 0
