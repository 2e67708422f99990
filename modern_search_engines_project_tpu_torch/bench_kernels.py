"""A/B bench of the slot U-dedup kernels: the dispatch gate's fit.

    python -m modern_search_engines_project_tpu_torch.bench_kernels [n_docs] [gate_fit|variants]

(defaults 100000 and ``gate_fit``).  Runs on the card and raises without
one.  It builds the synthetic index of ``synthetic.make_artifacts`` at
``n_docs`` documents (the repository's bench corpus; 100k docs is its own
scale) on the slot layout, then measures, as the JAX package's
``bench_kernels.py gate_fit`` does, every cell the dispatch gate
``udedup_plan`` chooses between:

  * B in {16, 64} x U in {128, 256, 512, 1024}, ``uids = arange(U)`` (the
    U most frequent terms), ``w = floor(3 |N(0, 1)|) + 1`` of shape [2B, U]
    from a seeded ``torch.Generator``;
  * per cell the U-dedup variants "sublane" (TPU kernel 2), "i8" (3),
    "acc" (5), "wide" and "wide_i8" (6);
  * per B a plain row (kernel 1 on B queries of T = 16 terms drawn by
    document frequency) and a floor row (one trivial launch a call).

Timing: n_scan inputs are staged first, 2 warm-up calls run, then the
n_scan calls are launched back to back between two CUDA events; a row's
time is the mean per call less the floor row's.  Each cell reports the
measured winner, the gate's pick and whether the pick is within 10% +
0.05 ms of the winner.

Parity (``variants`` runs it alone): on one input per cell, every
variant's keyed output against kernel 2's; more than 1e-5 + 1e-6 x |score|
apart, or a doc keyed on one side and not on the other, fails the run.
The relative term is for "acc": its split product sums in another order,
and these weights (up to ~16 on every id) give scores of several hundred,
where an f32 ulp is 3e-5.  It also reports which variants are
bit-identical to kernel 2.

The result is one JSON line.  ``gate_fit(didx, dfs, device="cpu")`` runs
the same code through the plain versions on the host clock (the tests use
it); such times are host times, not device times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from modern_search_engines_project_tpu_torch.config import Config
from modern_search_engines_project_tpu_torch.retrieval.bm25_slots import (
    bm25_score_slots,
    bm25_score_slots_udedup,
    udedup_plan,
)
from modern_search_engines_project_tpu_torch.retrieval.device_index import (
    DeviceIndex,
    resolve_device,
)
from modern_search_engines_project_tpu_torch.synthetic import make_artifacts

VARIANTS = ("sublane", "i8", "acc", "wide", "wide_i8")
B_CELLS = (16, 64)
U_CELLS = (128, 256, 512, 1024)
T_PLAIN = 16
N_SCAN = 32
SEED = 7
PARITY_ATOL = 1e-5
PARITY_RTOL = 1e-6


def bench_weights(gen, B: int, U: int, device):
    """The JAX bench's U-dedup input: integer weights floor(3|N(0,1)|) + 1
    in every row of [2B, U] (so every id is present in every query)."""
    z = torch.randn(2 * B, U, generator=gen, device=gen.device)
    return (torch.floor(3.0 * z.abs()) + 1.0).to(device)


def plain_queries(gen, probs, B: int, device):
    """B queries of T_PLAIN term ids drawn by document frequency, qtf 1."""
    tids = torch.multinomial(probs, B * T_PLAIN, replacement=True,
                             generator=gen).reshape(B, T_PLAIN)
    return (tids.to(device=device, dtype=torch.int32),
            torch.ones(B, T_PLAIN, dtype=torch.float32, device=device))


def time_calls(fn, inputs, warmup: int = 2) -> float:
    """Mean ms per call of ``fn(*x)`` over ``inputs``, launched back to
    back: between CUDA events on the card, on the host clock on the CPU."""
    for x in inputs[:warmup]:
        fn(*x)
    if inputs[0][0].device.type == "cuda":
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for x in inputs:
            fn(*x)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / len(inputs)
    t0 = time.perf_counter()
    for x in inputs:
        fn(*x)
    return (time.perf_counter() - t0) * 1e3 / len(inputs)


def parity(didx, uids, w):
    """Every variant's keyed output against kernel 2's on one input: max
    abs difference, agreement within the tolerance, bit identity."""
    base = bm25_score_slots_udedup(didx, uids, w, "sublane")
    out = {}
    for v in VARIANTS[1:]:
        got = bm25_score_slots_udedup(didx, uids, w, v)
        err = (got - base).abs()
        ok = bool((err <= PARITY_ATOL + PARITY_RTOL * base.abs()).all())
        out[v] = {
            "max_abs_err": float(err.max().item()),
            "within_tol": ok and bool(torch.equal(got < 0, base < 0)),
            "bit_identical": bool(torch.equal(got, base)),
        }
    return out


def gate_fit(didx, dfs, *, n_scan: int = N_SCAN, u_cells=U_CELLS,
             timed: bool = True):
    """The cell matrix on ``didx``'s device.  Returns (rows, gate, parity):
    rows are raw ms per call ("floor_b16", "plain_b16", "ud_acc_b16_U128",
    ...), gate the floor-corrected cells with winner, pick and agreement,
    parity the per-cell comparison with kernel 2.  Raises if a variant is
    off kernel 2 (``parity``).  ``timed=False`` runs the parity check
    alone."""
    dev = didx.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    probs = torch.as_tensor(dfs / dfs.sum(), dtype=torch.float32, device=dev)
    rows, gate, par = {}, {}, {}
    for B in B_CELLS:
        if timed:
            qs = [plain_queries(gen, probs, B, dev) for _ in range(n_scan)]
            rows[f"floor_b{B}"] = time_calls(
                lambda t, q: t.new_zeros((B, 1)), qs
            )
            rows[f"plain_b{B}"] = time_calls(
                lambda t, q: bm25_score_slots(didx, t, q), qs
            )
        for U in u_cells:
            uids = torch.arange(U, dtype=torch.int32, device=dev)
            ws = [(bench_weights(gen, B, U, dev),)
                  for _ in range(n_scan if timed else 1)]
            p = parity(didx, uids, ws[0][0])
            bad = {v: r for v, r in p.items() if not r["within_tol"]}
            if bad:
                raise RuntimeError(f"B={B} U={U}: off kernel 2: {bad}")
            par[f"B{B}_U{U}"] = p
            if not timed:
                continue
            for v in VARIANTS:
                rows[f"ud_{v}_b{B}_U{U}"] = time_calls(
                    lambda w, v=v: bm25_score_slots_udedup(didx, uids, w, v),
                    ws,
                )
            floor = rows[f"floor_b{B}"]
            meas = {"plain": rows[f"plain_b{B}"] - floor}
            for v in VARIANTS:
                meas[v] = rows[f"ud_{v}_b{B}_U{U}"] - floor
            winner = min(meas, key=meas.get)
            pick = udedup_plan(U, B) or "plain"
            gate[f"B{B}_U{U}"] = {
                **meas,
                "floor": floor,
                "measured_winner": winner,
                "gate_pick": pick,
                "agree": bool(meas[pick] <= 1.10 * meas[winner] + 0.05),
            }
    return rows, gate, par


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def build_index(n_docs: int, device):
    """(DeviceIndex on the slot layout, posting count, document
    frequencies) of the synthetic corpus at ``n_docs`` docs, seed 0 (the
    index ``chip_smoke.py`` builds at 100k docs)."""
    art, _, dfs = make_artifacts(
        0, n_docs=n_docs, n_terms=max(50_000, n_docs // 2),
        nnz_target=80 * n_docs,
    )
    didx = DeviceIndex.from_artifacts(art, Config(), device=device,
                                      bm25_layout="slots")
    return didx, art.post_docs.size, dfs


def run(n_docs: int = 100_000, mode: str = "gate_fit", device=None) -> dict:
    """Build the index and run ``mode``; returns the result dict."""
    if mode not in ("gate_fit", "variants"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = resolve_device(device)
    t0 = time.time()
    didx, nnz, dfs = build_index(n_docs, dev)
    built = time.time() - t0
    rows, gate, par = gate_fit(didx, dfs, timed=mode == "gate_fit")
    out = {
        "n_docs": n_docs,
        "nnz": int(nnz),
        "device": smi_line() if dev.type == "cuda" else "cpu (host clock)",
        "mode": mode,
        "n_scan": N_SCAN,
        "index_build_s": built,
        **rows,
        "parity": par,
    }
    if gate:
        out["gate_fit"] = gate
        out["gate_agreement"] = (
            f"{sum(c['agree'] for c in gate.values())}/{len(gate)}"
        )
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_docs = int(argv[0]) if argv else 100_000
    mode = argv[1] if len(argv) > 1 else "gate_fit"
    res = run(n_docs, mode)
    if "gate_fit" in res:
        print(f"gate agreement: {res['gate_agreement']} cells",
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
