"""Async polite fetch layer (reference C11, urlRequestManagement.py).

1.5 s timeout, redirects NOT followed (the status policy decides,
urlRequestManagement.py:98), per-domain robots.txt fetched+cached
alongside the first page of a domain (urlRequestManagement.py:38-85).
The transport is injectable so tests run fully offline.

A copy of the reference package's ``crawler/fetch.py`` but for the
default transport: ``AsyncioTransport``, HTTP/1.1 GETs on the standard
library's asyncio streams (TLS through ``ssl`` for https), with the
contract of ``HttpxTransport`` (``get(url) -> (status, headers, text)``,
the same request headers, the body decoded by its charset, else UTF-8,
with replacement).  ``HttpxTransport`` stays for callers who pass it;
httpx is imported only when one is built.
"""

from __future__ import annotations

import asyncio
import dataclasses
import ssl
import urllib.parse
from typing import Callable, Dict, List, Optional

from modern_search_engines_project_tpu_torch.crawler.helpers import get_domain
from modern_search_engines_project_tpu_torch.crawler.robots import USER_AGENT

TIMEOUT_S = 1.5  # urlRequestManagement.py:98
HEADERS = {
    "User-Agent": f"{USER_AGENT} (+course-project; polite; contact: none)",
    "Accept": "text/html,application/xhtml+xml,application/xml;q=0.9,*/*;q=0.5",
    "Accept-Language": "en;q=0.9,de;q=0.6",
}


@dataclasses.dataclass
class FetchResult:
    url: str
    status: int  # <=0 for connection failure
    text: str = ""
    content_type: str = ""
    location: Optional[str] = None  # redirect target
    retry_after: Optional[str] = None
    robots_text: Optional[str] = None  # set when robots was (re)fetched
    responded: bool = False


class HttpxTransport:
    """Real network transport."""

    def __init__(self, timeout: float = TIMEOUT_S):
        import httpx

        self._client = httpx.AsyncClient(
            timeout=timeout, follow_redirects=False, headers=HEADERS
        )

    async def get(self, url: str):
        resp = await self._client.get(url)
        return resp.status_code, dict(resp.headers), resp.text

    async def aclose(self):
        await self._client.aclose()


class AsyncioTransport:
    """HTTP/1.1 over ``asyncio.open_connection``: one connection a request
    (``Connection: close``), ``timeout`` seconds for the connect and for
    each read, a ``Content-Length``, chunked or read-to-close body, no
    redirect followed.  Header names come back lower-cased."""

    def __init__(self, timeout: float = TIMEOUT_S):
        self.timeout = timeout
        self._ssl: Optional[ssl.SSLContext] = None

    async def _read(self, coro):
        return await asyncio.wait_for(coro, self.timeout)

    async def get(self, url: str):
        parts = urllib.parse.urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"unsupported scheme: {url}")
        tls = parts.scheme == "https"
        if tls and self._ssl is None:
            self._ssl = ssl.create_default_context()
        host = parts.hostname or ""
        port = parts.port or (443 if tls else 80)
        target = urllib.parse.urlunsplit(
            ("", "", parts.path or "/", parts.query, ""))
        netloc = parts.netloc.rsplit("@", 1)[-1]
        reader, writer = await self._read(asyncio.open_connection(
            host, port, ssl=self._ssl if tls else None))
        try:
            head = [f"GET {target} HTTP/1.1", f"Host: {netloc}",
                    "Accept-Encoding: identity", "Connection: close"]
            head += [f"{k}: {v}" for k, v in HEADERS.items()]
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
            await self._read(writer.drain())
            status_line = await self._read(reader.readline())
            fields = status_line.decode("latin-1").split(None, 2)
            if len(fields) < 2 or not fields[0].startswith("HTTP/"):
                raise ConnectionError(f"bad status line {status_line!r}")
            status = int(fields[1])
            headers: Dict[str, str] = {}
            while True:
                line = await self._read(reader.readline())
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = await self._body(reader, headers)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass
        return status, headers, body.decode(_charset(headers), "replace")

    async def _body(self, reader, headers) -> bytes:
        if "chunked" in headers.get("transfer-encoding", "").lower():
            out = bytearray()
            while True:
                size = int((await self._read(reader.readline()))
                           .split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    while (await self._read(reader.readline())) not in (
                            b"\r\n", b"\n", b""):
                        pass
                    return bytes(out)
                out += await self._read(reader.readexactly(size))
                await self._read(reader.readline())
        if "content-length" in headers:
            return await self._read(
                reader.readexactly(int(headers["content-length"])))
        return await self._read(reader.read())

    async def aclose(self):
        pass


def _charset(headers: Dict[str, str]) -> str:
    for param in headers.get("content-type", "").split(";")[1:]:
        k, _, v = param.partition("=")
        if k.strip().lower() == "charset" and v.strip():
            name = v.strip().strip("\"'")
            try:
                "".encode(name)
                return name
            except LookupError:
                break
    return "utf-8"


class Fetcher:
    def __init__(self, transport=None, max_concurrency: int = 100):
        self._transport = transport
        self._sem = asyncio.Semaphore(max_concurrency)
        self._robots_seen: Dict[str, bool] = {}

    def _ensure_transport(self):
        if self._transport is None:
            self._transport = AsyncioTransport()
        return self._transport

    async def fetch_one(self, url: str) -> FetchResult:
        transport = self._ensure_transport()
        domain = get_domain(url)
        robots_text = None
        async with self._sem:
            # fetch robots.txt once per domain (cached flag; content cached
            # by the caller's RobotsCache)
            if domain and not self._robots_seen.get(domain):
                self._robots_seen[domain] = True
                try:
                    # robots.txt must come from the URL's full netloc —
                    # ``domain`` strips :port (reference getDomain regex,
                    # helpers.py), and fetching port 80 for a site on a
                    # non-default port fails silently, which would DROP the
                    # robots rules (caught by tests/test_crawl_live_http.py).
                    # urlsplit (not string slicing) so path-less URLs with a
                    # query/fragment don't leak it into the robots URL;
                    # userinfo is stripped.
                    parts = urllib.parse.urlsplit(url)
                    netloc = parts.netloc.rsplit("@", 1)[-1]
                    code, _h, body = await transport.get(
                        f"{parts.scheme}://{netloc}/robots.txt"
                    )
                    robots_text = body if 200 <= code < 300 else ""
                except Exception:
                    robots_text = ""
            try:
                code, headers, body = await transport.get(url)
            except Exception:
                return FetchResult(
                    url, status=0, robots_text=robots_text, responded=False
                )
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        return FetchResult(
            url=url,
            status=code,
            text=body if 200 <= code < 300 else "",
            content_type=headers.get("content-type", ""),
            location=headers.get("location"),
            retry_after=headers.get("retry-after"),
            robots_text=robots_text,
            responded=True,
        )

    async def fetch_many(self, urls: List[str]) -> List[FetchResult]:
        """<= max_concurrency parallel fetches (asyncio.gather parity,
        urlRequestManagement.py:96-102)."""
        return list(
            await asyncio.gather(*(self.fetch_one(u) for u in urls))
        )

    async def aclose(self):
        if self._transport is not None and hasattr(self._transport, "aclose"):
            await self._transport.aclose()
