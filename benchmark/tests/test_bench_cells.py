"""The harness finds cells, configurations, mixes and metric readers by
name, so a later change adds them as new files only."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest

from benchmark import cells, run

READER = '''
UNIT = "ms"
SOURCE = "program_span"
LAYER = "A new layer"
MOVES = "setup_s"


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
              "moves": "setup_s", "workloads": ["new.cell"]}
    spec["per_layer"].append(metric)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    c = cells.cell("new.cell", root=root)
    assert c["config"]["name"] == "new-conf"
    assert c["traffic"]["rate_qps"] == 5.0
    assert [m["name"] for m in c["per_layer"]] == ["new.metric"]
    assert cells.reader(metric, here=root / "benchmark").read(None) == 1.5
    # nothing that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())


# A kind of new files only: a tiny HTTP server that doubles a number, on
# its own path, judged by exact match.
ECHO_KIND = '''
import http.server
import json
import threading
import time

PATH = "/api/double"


class Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_POST(self):
        x = json.loads(self.rfile.read(int(self.headers["Content-Length"])))["x"]
        self.server.served += 1
        out = json.dumps({"y": 2 * x + self.server.wrong}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


class Program:
    def __init__(self, wrong):
        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.srv.served, self.srv.wrong = 0, wrong
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever)
        self.thread.start()

    def counters(self):
        n = self.srv.served
        return {"at": time.monotonic(), "plane": {"queries": n, "batches": n},
                "stages": {}}

    def stop(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(10)


def start(cell, seed, device, marks, wrong=0):
    prog = Program(wrong)
    marks["program"] = time.monotonic()
    return prog, None


def plan(cell, seed, seconds, state):
    t = cell["traffic"]
    header = {"loop": t["loop"], "path": PATH, "seconds": seconds,
              "drain_s": t["drain_s"]}
    if t["loop"] == "closed":
        header.update(connections=t["connections"], draw={"seed": seed},
                      sample=cell["config"]["correct"]["sample"])
        return {"header": header, "bodies": []}
    n = int(t["rate_qps"] * seconds)
    keep = list(range(0, n, 2))[: cell["config"]["correct"]["sample"]]
    header.update(offsets=[i / t["rate_qps"] for i in range(n)],
                  max_connections=t["max_connections"], keep=keep)
    return {"header": header, "bodies": [json.dumps({"x": i}) for i in range(n)]}


def stream(draw):
    at = [draw["seed"] % 997]

    def next_body():
        at[0] += 1
        return json.dumps({"x": at[0]})

    return next_body


def spans(program, state, cell):
    return None


def shapes(state, cell):
    return {}


def judge(cell, seed, state, sample, device):
    wrong = sum(1 for req, rep in sample
                if json.loads(rep)["y"] != 2 * json.loads(req)["x"])
    return {"mismatch": float(wrong)}, {}
'''

ECHO_READER = '''
UNIT = "replies"
SOURCE = "program_counter"
LAYER = "A stub server"
MOVES = "setup_s"


def read(ctx):
    return float(ctx.c1["plane"]["batches"] - ctx.c0["plane"]["batches"])
'''


def _echo_root(tmp: Path, loop: str) -> Path:
    """A copied root with a cell of the stub kind, its configuration, mix
    and reader added as new files and entries."""
    root = _copy_root(tmp)
    b = root / "benchmark"
    (b / "kinds" / "echo.py").write_text(ECHO_KIND)
    (b / "configs" / "echo-conf.json").write_text(json.dumps(
        {"name": "echo-conf", "kind": "echo", "reduced": [],
         "correct": {"sample": 8, "limits": {"mismatch": 0}}}))
    mix = {"loop": loop, "drain_s": 5, "profile_seconds": 1}
    mix.update({"rate_qps": 20.0, "max_connections": 8} if loop == "open"
               else {"connections": 2})
    (b / "traffic" / "echo_mix.json").write_text(json.dumps(mix))
    (b / "metrics" / "echo.replies.py").write_text(ECHO_READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "echo-conf", "source": "https://example.org",
                            "file": "benchmark/configs/echo-conf.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "echo.cell", "config": "echo-conf",
                              "traffic": "echo_mix", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "echo.replies", "unit": "replies",
                              "better": "higher", "source": "program_counter",
                              "layer": "A stub server", "moves": "setup_s",
                              "workloads": ["echo.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("loop, trace", [("open", False), ("closed", True)])
def test_a_cell_of_a_new_kind_runs_from_new_files_only(tmp_path, loop, trace):
    before = {p: p.read_bytes() for p in cells.HERE.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    root = _echo_root(tmp_path, loop)
    copied = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    cell = cells.cell("echo.cell", root=root)
    r = run.run_cell(cell, 3_000_000_023, 1.0, trace, device="cpu",
                     t_start=time.monotonic())
    assert r["correct"], r["checks"]
    assert r["attempted"] > 8 and r["failed"] == 0
    assert {k: v["value"] for k, v in r["checks"].items()} == {
        "mismatch": 0.0, "judged_short": 0, "sample_failed": 0}
    want = {"echo.replies"} if trace else {"setup_s"}
    assert set(r["metrics"]) == want
    # the stub's exact match fails a wrong reply
    bad = run.run_cell(cell, 3_000_000_023, 1.0, False, device="cpu",
                       t_start=time.monotonic(), wrong=1)
    assert not bad["correct"] and bad["checks"]["mismatch"]["value"] == 8.0
    # nothing that was there changed, in the copy or here
    for p, b in copied.items():
        if p.name not in ("echo.py", "echo-conf.json", "echo_mix.json",
                          "echo.replies.py"):
            assert p.read_bytes() == b
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_reader_must_agree_with_its_entry(tmp_path):
    root = _copy_root(tmp_path)
    (root / "benchmark" / "metrics" / "new.metric.py").write_text(READER)
    with pytest.raises(ValueError, match="UNIT"):
        cells.reader({"name": "new.metric", "unit": "s", "source": "program_span",
                      "layer": "A new layer", "moves": "setup_s"},
                     here=root / "benchmark")


def test_every_entry_has_its_files():
    spec = cells.spec()
    for w in spec["workloads"]:
        c = cells.cell(w["name"])
        kind = cells.kind_name(c["config"])
        if kind == "search":
            assert c["config"]["plane"] in ("data", "control")
        else:
            assert (cells.HERE / "kinds" / f"{kind}.py").is_file()
        assert c["traffic"]["loop"] in ("open", "closed")
        assert c["end_to_end"] and c["per_layer"]
        assert "setup_s" in [m["name"] for m in c["end_to_end"]]
    for m in spec["end_to_end"] + spec["per_layer"]:
        cells.reader(m)
    for conf in spec["configs"]:
        data = cells.load_json(cells.ROOT / conf["file"])
        assert data["name"] == conf["name"]
        assert data["reduced"] == conf["reduced"]
