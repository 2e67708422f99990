"""Cells, configurations, traffic mixes, kinds and metric readers, found
by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration is ``configs/<config>.json`` and the mix
``traffic/<traffic>.json`` beside this file, and each metric is read by
``metrics/<metric name>.py``.  A configuration's ``kind`` (``search``
where it names none) is the program it runs: ``kinds/<kind>.py``, which
starts that program, plans its requests and judges its replies.  A new
cell, mix, configuration, kind or metric is a new file and a new entry:
no file here changes.

A metric reader module sets ``UNIT``, ``SOURCE``, ``LAYER`` (None for an
end-to-end metric) and ``MOVES`` (the end-to-end metric it should move;
None for an end-to-end metric), and defines ``read(ctx)``, which returns
the metric's value, or None where the run gave it nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Dict:
    """The cell ``name`` with its configuration, traffic mix and the
    metrics it reports (``end_to_end`` and ``per_layer`` entries whose
    ``workloads`` hold it, or that have none)."""
    s = spec(root)
    found = [w for w in s["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = next(c for c in s["configs"] if c["name"] == w["config"])

    def mine(entries):
        return [m for m in entries
                if name in m.get("workloads", [name])]

    return {
        "name": name,
        "root": root,
        "chips": w["chips"],
        "config": load_json(root / conf["file"]),
        "traffic": load_json(root / "benchmark" / "traffic"
                             / f"{w['traffic']}.json"),
        "end_to_end": mine(s["end_to_end"]),
        "per_layer": mine(s["per_layer"]),
    }


def kind_name(cfg: Dict) -> str:
    """The kind a configuration names; ``search`` where it names none."""
    return cfg.get("kind", "search")


def kind(name: str, here: Path = HERE):
    """The kind module ``kinds/<name>.py`` under ``here``."""
    path = here / "kinds" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no kind {name!r}: {path} is missing")
    mod_name = "benchmark_kind_" + name.replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sys.modules[mod_name] = mod  # dataclasses look their module up there
    sp.loader.exec_module(mod)
    return mod


def reader(metric: Dict, here: Path = HERE):
    """The reader module of ``metric`` (a ``BENCHMARK.json`` entry),
    checked against the entry's unit, source, layer and arrow."""
    path = here / "metrics" / f"{metric['name']}.py"
    mod_name = "benchmark_metric_" + metric["name"].replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    want = {"UNIT": metric["unit"], "SOURCE": metric["source"],
            "LAYER": metric.get("layer"), "MOVES": metric.get("moves")}
    for k, v in want.items():
        if getattr(mod, k) != v:
            raise ValueError(f"{path.name}: {k} is {getattr(mod, k)!r}, "
                             f"BENCHMARK.json says {v!r}")
    return mod
