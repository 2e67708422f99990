"""One run of one benchmark cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  In one process, in order: start the
program of the cell's kind (``benchmark/kinds/<kind>.py``, which makes its
inputs and draws its weights from the seed on the card and warms the
cell's own shapes), start the load generator (``benchmark/loadgen.py``)
as its own process with the kind's plan of requests, measure for
``--seconds``, stop and free the program, have the kind judge a sample of
the replies against its plain reference (``benchmark/check.py`` holds the
numbers to the configuration's limits) and print the result as the last
line of standard output.  With ``--trace 1`` the metrics are the cell's
per-layer ones, read from the kind's spans, the program's counters and a
``torch.profiler`` trace of the last few seconds of the window.

A kind module provides ``start(cell, seed, device, marks, **opts)`` ->
(program, state), the program with ``port``, ``counters()`` (``{"at",
"plane": {"queries", "batches"}, "stages": {name: (total_s, count)}}``)
and ``stop()``; ``plan(cell, seed, seconds, state)`` -> ``{"header",
"bodies"}`` for the load generator; ``stream(draw)``, the closed loop's
next body; ``spans(program, state, cell)``, the benchmark's spans or
None; ``shapes(state, cell)``, ``ctx.shapes``; and ``judge(cell, seed,
state, sample, device)`` -> (numbers, counts) over the sampled (request
body, reply body) pairs.

Exits non-zero, printing no result, without enough CUDA devices, or if
JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.monotonic()  # noqa: E402  (set-up counts from here)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, Optional  # noqa: E402

import torch  # noqa: E402

from benchmark import cells, check, stats, trace as trace_mod  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "modern_search_engines_project_tpu")


def banned_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package (whole names: the port's own name begins with the latter)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def cpu_seconds() -> float:
    """CPU seconds this process has used, in all its threads."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


class FullCollections:
    """The interpreter's full (generation 2) collections while installed:
    how many, and the seconds each held the interpreter."""

    def __init__(self):
        self.seconds, self._at = [], None

    def __call__(self, phase: str, info: Dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._at = time.monotonic()
        elif self._at is not None:
            self.seconds.append(time.monotonic() - self._at)

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def host_summary(c0: Dict, c1: Dict, full: FullCollections) -> str:
    """One line of the window's device batches, the engine's stage means
    and the full collections, read from the counters at its two ends."""
    q = c1["plane"]["queries"] - c0["plane"]["queries"]
    b = c1["plane"]["batches"] - c0["plane"]["batches"]
    parts = [f"{b} device batches, {q / max(b, 1):.2f} queries a batch"]
    for k, (tot, n) in sorted(c1["stages"].items()):
        tot0, n0 = c0["stages"].get(k, (0.0, 0))
        if n > n0:
            parts.append(f"{k} {1e3 * (tot - tot0) / (n - n0):.2f} ms")
    parts.append(f"full collections {len(full.seconds)}, "
                 f"{1e3 * sum(full.seconds):.1f} ms")
    return "; ".join(parts)


def sleep_until(t: float) -> None:
    d = t - time.monotonic()
    if d > 0:
        time.sleep(d)


class LoadGen:
    """The load generator process (``python -m benchmark.loadgen``)."""

    def __init__(self, root: Path):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.loadgen"], cwd=root,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def prepare(self, header: Dict, bodies) -> None:
        header = dict(header, n_bodies=len(bodies))
        self.proc.stdin.write(json.dumps(header) + "\n")
        self.proc.stdin.write("".join(b + "\n" for b in bodies))
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if line.strip() != "ready":
            raise RuntimeError(f"load generator did not start: {line!r}")

    def go(self, start: float) -> None:
        self.proc.stdin.write(f"{start!r}\n")
        self.proc.stdin.close()

    def result(self, timeout: float) -> Dict:
        out = self.proc.stdout.read()
        self.proc.wait(timeout)
        if self.proc.returncode != 0:
            raise RuntimeError(f"load generator exited {self.proc.returncode}")
        return json.loads(out.strip().splitlines()[-1])

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = T_START, **opts) -> Dict:
    """Run ``cell`` once; ``opts`` go to its kind's ``start``.  Returns the
    result line's object, with keys that start with "_" for ``main`` to
    print on earlier lines."""
    cfg, traffic = cell["config"], cell["traffic"]
    root = Path(cell.get("root", cells.ROOT))
    name = cells.kind_name(cfg)
    kind = cells.kind(name, root / "benchmark")
    gen = LoadGen(root)
    prog = None
    try:
        marks = {"start": t_start}
        prog, state = kind.start(cell, seed, device, marks, **opts)
        spans = kind.spans(prog, state, cell) if trace else None
        plan = kind.plan(cell, seed, seconds, state)
        gen.prepare(dict(plan["header"], port=prog.port, kind=name),
                    plan["bodies"])
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        dw = (trace_mod.DeviceWindow() if trace and device != "cpu"
              else None)
        t0 = time.monotonic() + 0.2
        gen.go(t0)
        setup_s = t0 - t_start
        marks["generator"] = t0
        t1 = t0 + seconds
        sleep_until(t0)
        c0 = prog.counters()
        cpu0 = cpu_seconds()
        prof = None
        with FullCollections() as full:
            if dw is not None:  # the window's last seconds
                sleep_until(t1 - min(traffic["profile_seconds"], seconds / 3))
                prof = {"c0": prog.counters()}
                dw.start()
            sleep_until(t1)
            c1 = prog.counters()
        cpu_s = cpu_seconds() - cpu0
        if dw is not None:  # stopping holds the interpreter: after the window
            dw.stop()
            prof.update(t0=dw.t0, t1=dw.t1, c1=c1, ops=dw.ops())
            del dw
        out = gen.result(timeout=seconds + traffic["drain_s"] + 120)
        mem = int(torch.cuda.max_memory_allocated()) if device != "cpu" else 0
    finally:
        if prog is not None:
            prog.stop()
        gen.kill()
    batches = spans.batches(t0, t1) if spans is not None else []
    span_list = spans.spans if spans is not None else []
    shapes = kind.shapes(state, cell)
    del prog, spans
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    records = out["records"]
    if traffic["loop"] == "closed":
        records = [r for r in records if r[1] < t1]
    attempted = len(records)
    n_ok = sum(1 for r in records if stats.ok(r))
    by_index = {r[0]: r for r in records}
    sample = []
    sample_failed = 0
    for k in out["keep"]:
        r = by_index.get(k)
        if r is None or not stats.ok(r) or str(k) not in out["bodies"]:
            sample_failed += 1
        else:
            sample.append((out["requests"][str(k)], out["bodies"][str(k)]))
    numbers, counts = kind.judge(cell, seed, state, sample, device)
    wanted = min(attempted, cfg["correct"]["sample"])
    checks = check.checks(numbers, cfg["correct"]["limits"], counts={
        "judged_short": wanted - len(sample),
        "sample_failed": sample_failed,
        **counts})
    correct = check.verdict(checks) and len(sample) >= 1

    ctx = SimpleNamespace(
        records=records, t0=t0, t1=t1, seconds=seconds, setup_s=setup_s,
        c0=c0, c1=c1, batches=batches, spans=span_list, profile=prof,
        shapes=shapes, config=cfg, traffic=traffic)
    entries = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in entries:
        v = cells.reader(m, here=root / "benchmark").read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if device == "cpu":
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": mem}
    else:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell["chips"], "memory_peak_bytes": mem}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": attempted - n_ok, "metrics": metrics, "device": dev}
    if prof is not None:
        busy = trace_mod.busy_intervals(
            [(n, max(a, prof["t0"]), min(b, prof["t1"])) for n, a, b in prof["ops"]
             if b > prof["t0"] and a < prof["t1"]])
        dev["busy_s"] = sum(b - a for a, b in busy)
        dev["window_s"] = prof["t1"] - prof["t0"]
        tops = sorted(trace_mod.kernel_totals(prof["ops"]).items(),
                      key=lambda x: -x[1])[:10]
        gaps = sorted(trace_mod.idle_by_host_span(
            busy, span_list, prof["t0"], prof["t1"]).items(),
            key=lambda x: -x[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:120], s] for n, s in tops],
                               "idle_gaps": [[n, s] for n, s in gaps]}
        result["_trace"] = {
            "batches in the window": len(batches),
            "ranked in the profile": sum(
                1 for b in batches if prof["t0"] <= b.get("dr_start", -1) < prof["t1"]),
            "device operations": len(prof["ops"]),
            "first operation at": (prof["ops"][0][1] - prof["t0"]) if prof["ops"] else None,
            "profiled s": prof["t1"] - prof["t0"]}
    result["_cores"] = cpu_s / seconds
    result["_host"] = host_summary(c0, c1, full)
    ends = list(marks.items())
    result["_setup"] = {k: b - a for (_, a), (k, b) in zip(ends, ends[1:])}
    fails: Dict[str, int] = {}
    for r in records:
        if not (r[3] is not None and r[4] == 200):
            key = str(r[4]) if r[4] else (r[5] or "no reply")
            fails[key] = fails.get(key, 0) + 1
    result["_failures"] = fails
    lat = stats.latencies_ms(records)
    result["_latency_ms"] = {f"p{round(100 * q)}": stats.pct(lat, q)
                             for q in (0.5, 0.95, 0.99)}
    lat = sorted(stats.lateness_ms(records))
    result["checks"] = checks
    result["_lateness_ms"] = {
        "p50": lat[len(lat) // 2] if lat else None,
        "p99": lat[int(0.99 * (len(lat) - 1))] if lat else None,
        "max": lat[-1] if lat else None}
    return result


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = banned_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    late = result.pop("_lateness_ms")
    print(f"server process: {result.pop('_cores'):.2f} cores busy over the "
          f"window; failed requests by status or error: "
          f"{result.pop('_failures')}", file=sys.stderr)
    print(f"window: {result.pop('_host')}", file=sys.stderr)
    print("set-up s by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result.pop("_setup").items()),
        file=sys.stderr)
    tr = result.pop("_trace", None)
    if tr:
        print("trace: " + ", ".join(f"{k} {v}" for k, v in tr.items()),
              file=sys.stderr)
    print(f"generator lateness ms: p50 {late['p50']} p99 {late['p99']} "
          f"max {late['max']}", file=sys.stderr)
    print("client latency ms: " + " ".join(
        f"{k} {v}" for k, v in result.pop("_latency_ms").items()),
        file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
