"""Arithmetic over the load generator's records.

A request's latency runs from when it was due (the open loop's schedule,
or the closed loop's send) to the last byte of its reply.  A request that
failed, or got no reply, has an infinite latency: it misses every limit.
Percentiles are taken over every request of the window, by the nearest
rank below (``eval/load_test._pct``'s arithmetic).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

INF = float("inf")


def pct(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile of ``values`` by the nearest rank below."""
    v = sorted(values)
    return v[int(q * (len(v) - 1))] if v else INF


def ok(rec) -> bool:
    return rec[3] is not None and rec[4] == 200


def latencies_ms(records: Iterable) -> List[float]:
    return [(r[3] - r[1]) * 1e3 if ok(r) else INF for r in records]


def lateness_ms(records: Iterable) -> List[float]:
    """How late the generator sent each request it sent."""
    return [(r[2] - r[1]) * 1e3 for r in records if r[2] is not None]

