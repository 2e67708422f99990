"""``correct`` on the CPU at a tiny size: sound runs come out correct, and
runs with the served path broken underneath, or the lower-precision
control in the program's place, come out not correct.

Each run drives the whole harness (the corpus, the weights, the plane,
the load generator as its own process, the judging) except the look for a
chip: the program runs on the CPU with its kernels' plain versions."""

from __future__ import annotations

import time

import pytest

from benchmark import check, control, corpus as corpus_mod, run
from benchmark.tests import tiny

SEED = 3_000_000_017  # wider than 32 signed bits, as the driver's are


def _run(cell, faults=None, seconds=2.0):
    return run.run_cell(cell, SEED, seconds, False, device="cpu",
                        faults=faults, t_start=time.monotonic())


def _numbers(r):
    return {k: v["value"] for k, v in r["checks"].items()}


def test_sound_data_plane_run_is_correct():
    r = _run(tiny.cell("data", "open"))
    assert r["correct"], _numbers(r)
    assert r["failed"] == 0 and r["attempted"] == 40
    assert _numbers(r)["judged_short"] == 0  # all 16 sampled were judged
    assert _numbers(r)["bank_dtype_off"] == 0
    assert set(r["metrics"]) >= {"in_limit_pct", "setup_s"}


def test_sound_control_plane_run_with_stage3_is_correct():
    r = _run(tiny.cell("control", "open"))
    assert r["correct"], _numbers(r)


def test_sound_closed_loop_run_is_correct():
    r = _run(tiny.cell("data", "closed"))
    assert r["correct"], _numbers(r)
    assert r["attempted"] > 16 and _numbers(r)["judged_short"] == 0


def _half_batch(engine):
    """Half of each batch left out: its second half gets the first half's
    answers."""
    orig = engine.search_batch_indices

    def f(queries, *a, **k):
        res = orig(queries, *a, **k)
        h = (len(res) + 1) // 2
        return res[:h] + res[: len(res) - h]

    engine.search_batch_indices = f


def _altered(engine):
    """Each answer's first row names another window than the one chosen."""
    orig = engine.search_batch_indices
    n = len(engine.art.window_texts)

    def f(queries, *a, **k):
        return [[((r[0][0] + 1) % n, r[0][1])] + r[1:] if r else r
                for r in orig(queries, *a, **k)]

    engine.search_batch_indices = f


def _stale(engine):
    """Each batch answered with the previous batch's answers."""
    orig = engine.search_batch_indices
    last = {}

    def f(queries, *a, **k):
        res = orig(queries, *a, **k)
        prev = last.get("r", res)
        last["r"] = res
        return [prev[i % len(prev)] for i in range(len(res))]

    engine.search_batch_indices = f


@pytest.mark.parametrize("fault", [_half_batch, _altered, _stale],
                         ids=["half_batch", "altered_answer", "stale_answers"])
def test_broken_served_path_is_not_correct(fault):
    r = _run(tiny.cell("data", "closed"), faults=fault)
    assert not r["correct"], _numbers(r)


def test_altered_stage3_score_is_not_correct():
    def fault(engine):
        orig = engine.finish_batch

        def f(raw, queries, *a, **k):
            out = orig(raw, queries, *a, **k)
            for rows in out:
                if rows:
                    rows[0].similarity_score += 0.05
            return out

        engine.finish_batch = f

    r = _run(tiny.cell("control", "open"), faults=fault)
    assert not r["correct"], _numbers(r)


@pytest.mark.parametrize("plane", ["data", "control"])
def test_fp8_control_is_not_correct(plane):
    cell = tiny.cell(plane, "open")
    corp = corpus_mod.make_corpus(SEED, cell["config"]["corpus"], "cpu")
    checks = control.fp8_checks(cell, corp, SEED, "cpu")
    assert not check.verdict(checks), checks


def test_the_programs_int8_bank_is_not_correct():
    """The configuration states the bank's type; the program's own
    lower-precision bank, switched on, is held to it."""
    r = run.run_cell(tiny.cell("data", "open"), SEED, 2.0, False,
                     device="cpu", bank_dtype="int8", t_start=time.monotonic())
    assert not r["correct"]
    assert _numbers(r)["bank_dtype_off"] > 0
