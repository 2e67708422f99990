"""The load generator, run as its own process: ``python -m benchmark.loadgen``.

It reads one JSON header line and then one request body a line on
standard input, opens keep-alive connections to 127.0.0.1, prints
"ready", waits for one line holding the window's start on the shared
monotonic clock, runs the loop, and prints one JSON line of records.

Header keys: ``port``, ``path`` (where every request is posted),
``kind`` (the cell's kind, ``benchmark/kinds/<kind>.py``), ``loop``
("open" or "closed"), ``seconds``, ``drain_s``, ``n_bodies``; for the
open loop ``offsets`` (each request's send time from the start, one body
a request on standard input), ``max_connections`` (the most connections
it opens) and ``keep`` (indices of the requests whose replies come
back); for the closed loop ``connections`` (each sends its next request
when its reply arrives), ``draw`` (the arguments of the kind's
``stream``, which gives a fresh body for each request, so no pool runs
dry; its ``seed`` also seeds the sample) and ``sample`` (how many
requests, drawn uniformly from those sent by a seeded reservoir, have
their replies come back).  A header without ``path`` or ``kind`` is the
search kind's.

Each record is [index, due, sent, done, status, nbytes] in seconds of the
monotonic clock; ``done`` is the last byte of the reply, or null for a
request that failed or got no reply before ``seconds`` + ``drain_s``
(then ``nbytes`` names the error, where there was one).
The open loop sends request i at ``start + offsets[i]`` whatever is in
flight, so a stall delays what queues behind it; the closed loop stops
sending when the window closes.  The result line also holds ``keep``
(the indices whose replies came back), ``requests`` (their request
bodies) and ``bodies`` (their replies).
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from typing import List

import numpy as np

from benchmark import cells

CONNECT_AHEAD = 64  # connections opened before the window (open loop)


class Pool:
    """Keep-alive connections: an idle one is reused, else a new one is
    opened while fewer than ``limit`` are open, else the request waits."""

    def __init__(self, port: int, limit: int):
        self.port, self.limit = port, limit
        self.idle: List = []
        self.opened = 0
        self.freed = asyncio.Condition()

    async def open(self):
        self.opened += 1
        try:
            return await asyncio.open_connection("127.0.0.1", self.port)
        except OSError:
            self.opened -= 1
            raise

    async def get(self):
        async with self.freed:
            while not self.idle and self.opened >= self.limit:
                await self.freed.wait()
            if self.idle:
                return self.idle.pop()
        return await self.open()

    async def put(self, conn, ok: bool):
        if not ok:
            conn[1].close()
            self.opened -= 1
        else:
            self.idle.append(conn)
        async with self.freed:
            self.freed.notify()

    def close(self):
        for _, w in self.idle:
            w.close()


def request_bytes(path: str, body: bytes) -> bytes:
    return (f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


async def exchange(conn, data: bytes):
    """(status, body, keep) of one request on ``conn``."""
    reader, writer = conn
    writer.write(data)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    length, keep = 0, True
    for line in lines[1:]:
        k, _, v = line.partition(":")
        k = k.strip().lower()
        if k == "content-length":
            length = int(v)
        elif k == "connection" and v.strip().lower() == "close":
            keep = False
    body = await reader.readexactly(length)
    return status, body, keep


class Reservoir:
    """A uniform sample of ``k`` of the indices offered, one at a time,
    drawn from ``seed`` (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng([int(seed), 4])
        self.slots: List[int] = []
        self.seen = 0

    def offer(self, i: int):
        """(kept, evicted): whether ``i`` is in the sample now, and the
        index it pushed out, or None."""
        self.seen += 1
        if len(self.slots) < self.k:
            self.slots.append(i)
            return True, None
        j = int(self.rng.integers(self.seen))
        if j >= self.k:
            return False, None
        out, self.slots[j] = self.slots[j], i
        return True, out


async def one(pool: Pool, i: int, data: bytes, rec: dict, keep: set,
              bodies: dict):
    try:
        conn = await pool.get()
    except OSError:
        return
    rec[i][2] = time.monotonic()
    ok = False
    try:
        status, body, ok = await exchange(conn, data)
        rec[i][3] = time.monotonic()
        rec[i][4], rec[i][5] = status, len(body)
        if i in keep:
            bodies[i] = body.decode("utf-8", "replace")
    except (OSError, asyncio.IncompleteReadError, ValueError,
            IndexError) as e:
        ok = False
        rec[i][5] = type(e).__name__
    finally:
        await pool.put(conn, ok)


async def open_loop(hdr, datas, pool, start, rec, keep, bodies):
    tasks = []
    for i, off in enumerate(hdr["offsets"]):
        due = start + off
        rec[i] = [i, due, None, None, 0, 0]
        delay = due - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.ensure_future(
            one(pool, i, datas[i], rec, keep, bodies)))
    return tasks


async def closed_loop(hdr, next_body, pool, start, rec, keep, bodies,
                      requests, path):
    end = start + hdr["seconds"]
    sample = Reservoir(hdr["sample"], hdr["draw"]["seed"])
    counter = iter(range(1 << 62))
    delay = start - time.monotonic()
    if delay > 0:
        await asyncio.sleep(delay)

    async def client():
        while time.monotonic() < end:
            i = next(counter)
            body = next_body()
            kept, out = sample.offer(i)
            if out is not None:
                keep.discard(out)
                bodies.pop(out, None)
                requests.pop(out, None)
            if kept:
                keep.add(i)
                requests[i] = body
            rec[i] = [i, time.monotonic(), None, None, 0, 0]
            await one(pool, i, request_bytes(path, body.encode()), rec, keep,
                      bodies)

    return [asyncio.ensure_future(client())
            for _ in range(hdr["connections"])]


async def main_async(hdr, texts, stdin, stdout) -> dict:
    path = hdr.get("path", "/api/search")
    rec: dict = {}
    bodies: dict = {}
    if hdr["loop"] == "open":
        keep = set(hdr.get("keep", ()))
        requests = {i: texts[i] for i in keep}
        datas = [request_bytes(path, t.encode()) for t in texts]
        pool = Pool(hdr["port"], hdr["max_connections"])
        n_ahead = min(CONNECT_AHEAD, hdr["max_connections"])
    else:
        keep, requests = set(), {}
        next_body = cells.kind(hdr.get("kind", "search")).stream(hdr["draw"])
        next_body()  # the first draw (a block of queries) before the window
        pool = Pool(hdr["port"], hdr["connections"])
        n_ahead = hdr["connections"]
    pool.idle.extend([await pool.open() for _ in range(n_ahead)])
    print("ready", file=stdout, flush=True)
    start = float(await asyncio.get_running_loop().run_in_executor(
        None, stdin.readline))
    if hdr["loop"] == "open":
        tasks = await open_loop(hdr, datas, pool, start, rec, keep, bodies)
    else:
        tasks = await closed_loop(hdr, next_body, pool, start, rec, keep,
                                  bodies, requests, path)
    limit = start + hdr["seconds"] + hdr["drain_s"]
    _, pending = await asyncio.wait(
        tasks, timeout=max(0.0, limit - time.monotonic()))
    for t in pending:
        t.cancel()
    await asyncio.gather(*pending, return_exceptions=True)
    pool.close()
    for r in rec.values():
        if r[3] is not None and r[3] > limit:
            r[3] = None  # came after the drain: no reply
    return {"records": [rec[i] for i in sorted(rec)],
            "keep": sorted(keep),
            "requests": {str(k): v for k, v in requests.items()},
            "bodies": {str(k): v for k, v in bodies.items()}}


def main(stdin=sys.stdin, stdout=sys.stdout) -> None:
    hdr = json.loads(stdin.readline())
    texts = [stdin.readline().rstrip("\n") for _ in range(int(hdr["n_bodies"]))]
    out = asyncio.run(main_async(hdr, texts, stdin, stdout))
    stdout.write(json.dumps(out) + "\n")
    stdout.flush()


if __name__ == "__main__":
    main()
