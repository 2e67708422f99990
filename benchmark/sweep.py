"""Find a search configuration's knee: the highest offered rate its plane
keeps.

On the chip, in one process (one set-up), an open loop of the cell's
query model at each rate for ``--seconds``:

    python3 -m benchmark.sweep --workload api.steady --seed <n> \\
        --rates 100,200,300 --seconds 10 --out chiprun_out/sweep_api.json

Then, where the traffic file and PERF.md live:

    python3 -m benchmark.sweep --apply chiprun_out/sweep_api.json --limit-ms 100

writes the knee under the latency limit, and ``--share`` (0.8 unless
given) of the knee as the traffic file's ``rate_qps``, into the cell's traffic file and into
PERF.md between the markers ``<!-- sweep:<workload> -->`` and
``<!-- /sweep:<workload> -->``.

A rate is kept when the generator kept its schedule (lateness p99 under
``LATE_MS``), every request was answered, the backlog did not grow (the
window's answers kept up with ``ANSWERED`` of the offered rate; the
requests still in flight at the close are what one latency holds) and
p95 stayed under the latency limit.  The knee is the highest rate kept
below the lowest rate that was not.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

LATE_MS = 50.0
ANSWERED = 0.95


def one_rate(prog, corp, cell, seed: int, rate: float, seconds: float,
             stream: int) -> dict:
    from benchmark import queries, run, stats
    from benchmark.kinds import search

    traffic = cell["traffic"]
    offsets = queries.arrivals(seed + stream, rate, seconds)
    qs = queries.draw_queries(seed, corp.words, corp.dfs, len(offsets),
                              traffic["queries"], stream=100 + stream)
    gen = run.LoadGen(run.cells.ROOT)
    try:
        gen.prepare({"loop": "open", "path": search.PATH,
                     "offsets": offsets.tolist(),
                     "max_connections": traffic["max_connections"],
                     "seconds": seconds, "drain_s": traffic["drain_s"],
                     "keep": [], "port": prog.port},
                    [json.dumps({"query": q}) for q in qs])
        t0 = time.monotonic() + 0.2
        gen.go(t0)
        cpu0 = run.cpu_seconds()
        run.sleep_until(t0 + seconds)
        cores = (run.cpu_seconds() - cpu0) / seconds
        out = gen.result(timeout=seconds + traffic["drain_s"] + 120)
    finally:
        gen.kill()
    rec = out["records"]
    lat = stats.latencies_ms(rec)
    third = max(1, len(lat) // 3)
    late = stats.lateness_ms(rec)
    return {"rate_qps": rate, "n": len(rec),
            "failed": sum(1 for r in rec if not stats.ok(r)),
            "p50_ms": stats.pct(lat, 0.5), "p95_ms": stats.pct(lat, 0.95),
            "p99_ms": stats.pct(lat, 0.99),
            "p95_first_ms": stats.pct(lat[:third], 0.95),
            "p95_last_ms": stats.pct(lat[-third:], 0.95),
            "late_p99_ms": stats.pct(late, 0.99), "server_cores": cores,
            "answered_qps": sum(1 for r in rec if stats.ok(r)
                                and r[3] <= t0 + seconds) / seconds}


def measure(args) -> dict:
    import torch

    from benchmark import cells
    from benchmark.kinds import search

    cell = cells.cell(args.workload)
    prog, state = search.start(cell, args.seed, "cuda", {})
    try:
        rows = [one_rate(prog, state.corp, cell, args.seed, r, args.seconds, i)
                for i, r in enumerate(args.rates)]
    finally:
        prog.stop()
    return {"workload": args.workload, "seed": args.seed,
            "seconds": args.seconds, "device": torch.cuda.get_device_name(0),
            "rows": rows}


def kept(row: dict, limit_ms: float) -> bool:
    return (row["failed"] == 0 and row["late_p99_ms"] < LATE_MS
            and row["answered_qps"] >= ANSWERED * row["rate_qps"]
            and row["p95_ms"] <= limit_ms)


def knee(rows, limit_ms: float) -> float:
    best = 0.0
    for row in sorted(rows, key=lambda r: r["rate_qps"]):
        if not kept(row, limit_ms):
            break
        best = row["rate_qps"]
    return best


def apply(path: Path, limit_ms: float, reason: str, share: float) -> None:
    from benchmark import cells

    res = json.loads(path.read_text())
    k = knee(res["rows"], limit_ms)
    name = res["workload"]
    w = next(w for w in cells.spec()["workloads"] if w["name"] == name)
    tpath = cells.HERE / "traffic" / f"{w['traffic']}.json"
    traffic = json.loads(tpath.read_text())
    traffic["rate_qps"] = round(share * k, 1)
    traffic["knee"] = {"qps": k, "limit_p95_ms": limit_ms, "share": share,
                       "sweep": f"{res['device']}, seed {res['seed']}, "
                                f"{res['seconds']} s a rate"}
    tpath.write_text(json.dumps(traffic, indent=1) + "\n")
    lines = [f"Sweep of `{name}` ({res['device']}, seed {res['seed']}, "
             f"{res['seconds']} s a rate): knee **{k} q/s** under p95 <= "
             f"{limit_ms} ms ({reason}); steady rate {traffic['rate_qps']} q/s "
             f"({share} x the knee).",
             "",
             "| offered q/s | answered q/s | p50 ms | p95 ms | p95 first / last third ms | lateness p99 ms | failed | kept |",
             "| --- | --- | --- | --- | --- | --- | --- | --- |"]
    for r in res["rows"]:
        lines.append(
            f"| {r['rate_qps']} | {r['answered_qps']:.1f} | {r['p50_ms']:.1f} | "
            f"{r['p95_ms']:.1f} | {r['p95_first_ms']:.1f} / {r['p95_last_ms']:.1f} | "
            f"{r['late_p99_ms']:.2f} | {r['failed']} | "
            f"{'yes' if kept(r, limit_ms) else 'no'} |")
    perf = cells.ROOT / "PERF.md"
    text = perf.read_text()
    a, b = f"<!-- sweep:{name} -->", f"<!-- /sweep:{name} -->"
    block = a + "\n" + "\n".join(lines) + "\n" + b
    if a in text:
        text = re.sub(re.escape(a) + ".*?" + re.escape(b), lambda _: block,
                      text, flags=re.S)
    else:
        text = text.rstrip("\n") + "\n\n" + block + "\n"
    perf.write_text(text)
    print(f"{name}: knee {k} q/s, rate_qps {traffic['rate_qps']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", type=lambda s: [float(x) for x in s.split(",")])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--apply", type=Path)
    ap.add_argument("--limit-ms", type=float)
    ap.add_argument("--reason", default="")
    ap.add_argument("--share", type=float, default=0.8)
    args = ap.parse_args(argv)
    if args.apply:
        apply(args.apply, args.limit_ms, args.reason, args.share)
        return 0
    res = measure(args)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1) + "\n")
    for r in res["rows"]:
        print(json.dumps(r), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
