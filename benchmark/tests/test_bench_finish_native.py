"""The readers of the native finishing pass's share (engine.finish_native_share,
.sat), on the CPU at a tiny size."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark import cells, run
from benchmark.tests import tiny

SEED = 3_000_000_024
NAMES = ("engine.finish_native_share", "engine.finish_native_share.sat")


def _reader(name):
    return cells.reader(next(m for m in cells.spec()["per_layer"]
                             if m["name"] == name))


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_every_batch_finishes_natively_in_a_traced_run(loop):
    r = run.run_cell(tiny.cell("data", loop), SEED, 2.0, True, device="cpu",
                     t_start=time.monotonic())
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    for name in NAMES:
        assert got.get(name) == 100.0, (name, got)


@pytest.mark.parametrize("name", NAMES)
def test_share_over_the_window(name):
    c0 = {"stages": {"finish_indices": (1.0, 10), "finish_native": (0.1, 6)}}
    c1 = {"stages": {"finish_indices": (2.0, 30), "finish_native": (0.2, 16)}}
    assert _reader(name).read(SimpleNamespace(c0=c0, c1=c1)) == 50.0
    # no batch finished in the window
    assert _reader(name).read(SimpleNamespace(c0=c1, c1=c1)) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_where_the_program_has_no_native_pass(name):
    """The parent's program records finish_indices and no finish_native:
    no number, and the reader does not raise."""
    stages = {"query_prep": (1.0, 10), "finish_indices": (0.5, 10)}
    ctx = SimpleNamespace(c0={"stages": {}}, c1={"stages": stages})
    assert _reader(name).read(ctx) is None
