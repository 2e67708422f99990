"""Share of the window's requests answered 200 within the mix's latency limit
(``knee.limit_p95_ms`` of its traffic file: the limit under which its plane's
knee was found, 400 ms for the search API), in percent; a failed request never
is.  None where the mix states no limit."""

from benchmark import stats

UNIT = "%"
SOURCE = "host_clock"
LAYER = None
MOVES = None


def read(ctx):
    limit = ctx.traffic.get("knee", {}).get("limit_p95_ms")
    if limit is None or not ctx.records:
        return None
    lat = stats.latencies_ms(ctx.records)
    return 100.0 * sum(1 for x in lat if x <= limit) / len(lat)
