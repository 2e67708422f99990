"""The harness finds cells, configurations, mixes and metric readers by
name, so a later change adds them as new files only."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark import cells

READER = '''
UNIT = "ms"
SOURCE = "program_span"
LAYER = "A new layer"
MOVES = "p95_ms"


def read(ctx):
    return 1.5
'''


def _copy_root(tmp: Path) -> Path:
    shutil.copytree(cells.HERE, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


def test_a_cell_of_new_files_only(tmp_path):
    root = _copy_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    (root / "benchmark" / "configs" / "new-conf.json").write_text(
        json.dumps({"name": "new-conf", "plane": "data"}))
    (root / "benchmark" / "traffic" / "new_mix.json").write_text(
        json.dumps({"loop": "open", "rate_qps": 5.0}))
    (root / "benchmark" / "metrics" / "new.metric.py").write_text(READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "new-conf", "source": "https://example.org",
                            "file": "benchmark/configs/new-conf.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "new.cell", "config": "new-conf",
                              "traffic": "new_mix", "chips": 1, "why": "a test"})
    metric = {"name": "new.metric", "unit": "ms", "better": "lower",
              "source": "program_span", "layer": "A new layer",
              "moves": "p95_ms", "workloads": ["new.cell"]}
    spec["per_layer"].append(metric)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    c = cells.cell("new.cell", root=root)
    assert c["config"]["name"] == "new-conf"
    assert c["traffic"]["rate_qps"] == 5.0
    assert [m["name"] for m in c["per_layer"]] == ["new.metric"]
    assert cells.reader(metric, here=root / "benchmark").read(None) == 1.5
    # nothing that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_reader_must_agree_with_its_entry(tmp_path):
    root = _copy_root(tmp_path)
    (root / "benchmark" / "metrics" / "new.metric.py").write_text(READER)
    with pytest.raises(ValueError, match="UNIT"):
        cells.reader({"name": "new.metric", "unit": "s", "source": "program_span",
                      "layer": "A new layer", "moves": "p95_ms"},
                     here=root / "benchmark")


def test_every_entry_has_its_files():
    spec = cells.spec()
    for w in spec["workloads"]:
        c = cells.cell(w["name"])
        assert c["config"]["plane"] in ("data", "control")
        assert c["traffic"]["loop"] in ("open", "closed")
        assert c["end_to_end"] and c["per_layer"]
        assert "setup_s" in [m["name"] for m in c["end_to_end"]]
    for m in spec["end_to_end"] + spec["per_layer"]:
        cells.reader(m)
    for conf in spec["configs"]:
        data = cells.load_json(cells.ROOT / conf["file"])
        assert data["name"] == conf["name"]
        assert data["reduced"] == conf["reduced"]
