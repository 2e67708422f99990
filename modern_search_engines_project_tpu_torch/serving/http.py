"""A small HTTP/1.1 server on ``asyncio.start_server`` for the control plane.

The reference's control plane is an aiohttp app; the port's runs where
only the standard library, torch and numpy are installed, so this module
gives ``serving/api.py`` the part of aiohttp's ``web`` it uses:

  * ``Request`` (method, path, query, case-insensitive headers,
    ``match_info``, ``await json()``) and ``Response``, ``json_response``
    (``json.dumps`` with its defaults, as aiohttp's) and ``FileResponse``;
  * ``Application``: POST and GET routes, GET paths with ``{param}``
    segments, one static directory (``..`` and symlinks that lead out of it
    are refused), and aiohttp-style middlewares ``mw(request, handler)``;
  * HTTP/1.1 framing: the request line, headers, a ``Content-Length`` body
    capped at ``client_max_size`` (413 above it; chunked request bodies get
    411), ``Expect: 100-continue``, keep-alive (HTTP/1.0 only on request);
  * ``run_app`` (one event loop; SIGINT and SIGTERM stop it cleanly,
    ``reuse_port`` for worker processes sharing a port) and
    ``ServerThread`` (an app on its own loop in a thread).

One event loop serves every connection, so handlers and the online batcher
mutate shared state without locks, as under aiohttp.
"""

from __future__ import annotations

import asyncio
import json
import logging
import mimetypes
import signal
import threading
import urllib.parse
from http import HTTPStatus
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("serving.http")

MAX_BODY = 16 * 1024 * 1024  # aiohttp's client_max_size in serving/api.py
MAX_LINE = 64 * 1024  # request line or one header line
MAX_HEADERS = 128
KEEPALIVE_S = 75.0  # idle keep-alive connections close after this
BODY_TIMEOUT_S = 60.0


class HTTPError(Exception):
    """An error answered with a plain-text ``"<status>: <reason>"`` body."""

    def __init__(self, status: int):
        super().__init__(status)
        self.status = status
        self.text = f"{status}: {HTTPStatus(status).phrase}"


class Headers:
    """Read-only, case-insensitive request headers (last value wins)."""

    def __init__(self, pairs: List[Tuple[str, str]]):
        self._d = {k.lower(): v for k, v in pairs}

    def get(self, key: str, default=None):
        return self._d.get(key.lower(), default)


class Request:
    def __init__(self, method: str, target: str, version: str,
                 headers: Headers, body: bytes = b""):
        self.method = method
        self.version = version
        self.headers = headers
        self.body = body
        split = urllib.parse.urlsplit(target)
        self.path = urllib.parse.unquote(split.path)
        self.raw_path = split.path
        query: Dict[str, str] = {}
        for k, v in urllib.parse.parse_qsl(split.query, keep_blank_values=True):
            query.setdefault(k, v)  # the first value, as MultiDict.get
        self.query = query
        self.match_info: Dict[str, str] = {}

    @property
    def keep_alive(self) -> bool:
        conn = (self.headers.get("Connection") or "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"

    async def text(self) -> str:
        return self.body.decode("utf-8")

    async def json(self):
        return json.loads(await self.text())


class Response:
    def __init__(
        self,
        *,
        body: Optional[bytes] = None,
        text: Optional[str] = None,
        status: int = 200,
        content_type: Optional[str] = None,
    ):
        if text is not None:
            body = text.encode("utf-8")
            content_type = content_type or "text/plain"
        self.body = body or b""
        self.status = status
        self.content_type = content_type or "application/octet-stream"
        self.headers: dict = {}  # middlewares add to it

    def encode(self, keep_alive: bool) -> bytes:
        ctype = self.content_type
        if (ctype.startswith("text/") or ctype == "application/json") and (
            "charset" not in ctype
        ):
            ctype += "; charset=utf-8"
        lines = [
            f"HTTP/1.1 {self.status} {HTTPStatus(self.status).phrase}",
            f"Content-Type: {ctype}",
            f"Content-Length: {len(self.body)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}",
        ]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        return head + self.body


def json_response(data, status: int = 200) -> Response:
    return Response(text=json.dumps(data), status=status,
                    content_type="application/json")


def FileResponse(path) -> Response:
    path = Path(path)
    ctype = mimetypes.guess_type(path.name)[0] or "application/octet-stream"
    return Response(body=path.read_bytes(), content_type=ctype)


Handler = Callable[[Request], "asyncio.Future"]


class Application:
    """Routes, one static root, middlewares."""

    def __init__(self, client_max_size: int = MAX_BODY, middlewares=()):
        self.client_max_size = client_max_size
        self.middlewares = list(middlewares)
        self._exact: Dict[Tuple[str, str], Handler] = {}
        self._patterns: List[Tuple[str, List[str], Handler]] = []
        self._static: Optional[Tuple[str, Path]] = None

    def _add(self, method: str, path: str, handler: Handler) -> None:
        if "{" in path:
            self._patterns.append((method, path.strip("/").split("/"), handler))
        else:
            self._exact[(method, path)] = handler

    def add_get(self, path: str, handler: Handler) -> None:
        self._add("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self._add("POST", path, handler)

    def add_static(self, prefix: str, root) -> None:
        self._static = ("/" + prefix.strip("/") + "/", Path(root).resolve())

    def _resolve(self, req: Request) -> Handler:
        """The handler for ``req`` (its ``match_info`` filled in); raises
        404 or 405."""
        h = self._exact.get((req.method, req.path))
        if h is not None:
            return h
        known = any(p == req.path for _, p in self._exact)
        parts = req.raw_path.strip("/").split("/")
        for method, segs, handler in self._patterns:
            if len(segs) != len(parts):
                continue
            info = {}
            for s, p in zip(segs, parts):
                if s.startswith("{") and s.endswith("}"):
                    if not p:
                        break
                    info[s[1:-1]] = urllib.parse.unquote(p)
                elif s != urllib.parse.unquote(p):
                    break
            else:
                if method == req.method:
                    req.match_info = info
                    return handler
                known = True
        if self._static and req.path.startswith(self._static[0]):
            if req.method != "GET":
                raise HTTPError(405)
            return self._serve_static
        raise HTTPError(405 if known else 404)

    async def _serve_static(self, req: Request) -> Response:
        prefix, root = self._static
        rel = req.path[len(prefix):]
        if any(part in ("..", "") for part in rel.split("/")) or "\\" in rel:
            raise HTTPError(403)
        target = (root / rel).resolve()
        if root not in target.parents:  # a symlink that leads outside
            raise HTTPError(403)
        if not target.is_file():
            raise HTTPError(404)
        return FileResponse(target)

    async def handle(self, req: Request) -> Response:
        """Route through the middlewares (outermost first, as aiohttp)."""

        async def route(request):
            return await self._resolve(request)(request)

        handler = route
        for mw in reversed(self.middlewares):
            handler = (lambda m, h: lambda r: m(r, h))(mw, handler)
        try:
            return await handler(req)
        except HTTPError as e:
            return Response(text=e.text, status=e.status)
        except Exception:
            log.exception("error handling %s %s", req.method, req.path)
            return Response(
                text="500 Internal Server Error\n\nServer got itself in "
                     "trouble",
                status=500,
            )


async def _read_request(reader: asyncio.StreamReader,
                        max_body: int, writer) -> Optional[Request]:
    """One request off the stream; None at a clean EOF between requests.
    Raises HTTPError for a malformed or refused request."""
    line = b"\r\n"
    while line in (b"\r\n", b"\n"):  # tolerate blank lines between requests
        line = await asyncio.wait_for(reader.readline(), KEEPALIVE_S)
        if not line:
            return None
    if not line.endswith(b"\n"):
        return None  # the peer closed mid-line
    parts = line.decode("latin-1").rstrip("\r\n").split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1.") or not (
        parts[0].isalpha() and parts[1].startswith("/")
    ):
        raise HTTPError(400)
    method, target, version = parts
    pairs = []
    while True:
        h = await asyncio.wait_for(reader.readline(), BODY_TIMEOUT_S)
        if not h.endswith(b"\n"):
            return None
        if h in (b"\r\n", b"\n"):
            break
        if len(pairs) >= MAX_HEADERS:
            raise HTTPError(431)
        name, sep, value = h.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip():
            raise HTTPError(400)
        pairs.append((name, value.strip()))
    headers = Headers(pairs)
    if "chunked" in (headers.get("Transfer-Encoding") or "").lower():
        raise HTTPError(411)
    n = headers.get("Content-Length")
    length = 0
    if n is not None:
        if not n.isdigit() or not n.isascii():
            raise HTTPError(400)
        length = int(n)
    if length > max_body:
        raise HTTPError(413)
    body = b""
    if length:
        if (headers.get("Expect") or "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        body = await asyncio.wait_for(reader.readexactly(length),
                                      BODY_TIMEOUT_S)
    return Request(method.upper(), target, version, headers, body)


class Server:
    """An ``Application`` listening on one address."""

    def __init__(self, app: Application, host: str, port: int,
                 reuse_port: bool = False):
        self.app, self.host, self.port = app, host, port
        self.reuse_port = reuse_port
        self._server = None
        self._conns: set = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port,
            reuse_port=self.reuse_port or None, limit=MAX_LINE,
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for w in list(self._conns):
            w.close()
        await self._server.wait_closed()
        self._server = None

    async def _serve_conn(self, reader, writer) -> None:
        self._conns.add(writer)
        try:
            while True:
                try:
                    req = await _read_request(
                        reader, self.app.client_max_size, writer)
                except HTTPError as e:  # answer, then drop the connection
                    writer.write(Response(text=e.text, status=e.status)
                                 .encode(keep_alive=False))
                    await writer.drain()
                    break
                except (ValueError, asyncio.LimitOverrunError):
                    writer.write(Response(text="400: Bad Request", status=400)
                                 .encode(keep_alive=False))
                    await writer.drain()
                    break
                if req is None:
                    break
                resp = await self.app.handle(req)
                keep = req.keep_alive
                writer.write(resp.encode(keep_alive=keep))
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()


def run_app(app: Application, host: str = "0.0.0.0", port: int = 5000,
            reuse_port: bool = False, handle_signals: bool = True) -> None:
    """Serve ``app`` until SIGINT or SIGTERM (with ``handle_signals``;
    else until the process ends), then close the listener and return."""

    async def main():
        srv = Server(app, host, port, reuse_port)
        await srv.start()
        log.info("serving on http://%s:%d", host, srv.port)
        stop = asyncio.Event()
        if handle_signals:
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stop.set)
        try:
            await stop.wait()
        finally:
            await srv.close()

    asyncio.run(main())


class ServerThread:
    """An ``Application`` on its own event loop in a daemon thread:
    ``start()`` returns once it listens (``.port`` is the bound port),
    ``stop()`` closes it and joins the thread."""

    def __init__(self, app: Application, host: str = "127.0.0.1",
                 port: int = 0):
        self.app, self.host, self.port = app, host, port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Event] = None
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        async def main():
            self._loop = asyncio.get_running_loop()
            self._stop = asyncio.Event()
            srv = Server(self.app, self.host, self.port)
            try:
                await srv.start()
            except BaseException as e:
                self._error = e
                self._ready.set()
                return
            self.port = srv.port
            self._ready.set()
            try:
                await self._stop.wait()
            finally:
                await srv.close()

        asyncio.run(main())

    def start(self, timeout: float = 30.0) -> "ServerThread":
        self._thread.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("server thread did not start listening")
        if self._error is not None:
            raise self._error
        return self

    def stop(self, timeout: float = 30.0) -> None:
        if self._loop is not None and self._thread.is_alive():
            self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(timeout)
