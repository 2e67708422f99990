"""Both crawlers against one real loopback site: the reference's over
``HttpxTransport``, the port's over its default ``AsyncioTransport``
(standard-library sockets, no httpx).  The site is a ``http.server`` in a
thread on 127.0.0.1 with robots.txt (``/private`` disallowed, crawl delay
0), link expansion, a redirect (not followed by the transport; the status
policy follows it) and a 404.  The stored pages (url, title, text,
tueEngScore) and the robots decisions must be equal, and the port's
transport must answer as httpx does, request by request."""

import asyncio
import http.server
import sqlite3
import threading

import pytest

import modern_search_engines_project_tpu.crawler as ref
import modern_search_engines_project_tpu_torch.crawler as port
from modern_search_engines_project_tpu.crawler.fetch import HttpxTransport


def _page(title, links, extra=""):
    anchors = "".join(f'<a href="{u}">{u}</a>' for u in links)
    return (
        f"<html><head><title>{title}</title></head><body><main>"
        f"Tuebingen Tuebingen Tuebingen is a university town in Germany on "
        f"the Neckar river in Baden-Wuerttemberg in the Swabian hills. The "
        f"research institute and the faculty campus host a seminar and a "
        f"lecture for every professor. Stocherkahn punting starts at the "
        f"Marktplatz. {extra} {anchors}</main></body></html>"
    )


def routes(base):
    return {
        "/robots.txt": (200, "User-agent: *\nDisallow: /private\n"
                             "Crawl-delay: 0\n", "text/plain", {}),
        "/": (200, _page("Home", [f"{base}/a", f"{base}/b",
                                  f"{base}/private/x", f"{base}/old",
                                  f"{base}/gone"]), "text/html", {}),
        "/a": (200, _page("Alpha", [f"{base}/b"], "alpha law faculty"),
               "text/html; charset=utf-8", {}),
        "/b": (200, _page("Beta", [f"{base}/", f"{base}/c"],
                          "beta library science – Tübingen"),
               "text/html; charset=utf-8", {}),
        "/c": (200, _page("Gamma", [], "gamma chunked"), "text/html",
               {"chunked": True}),
        "/old": (301, "", "text/html", {"Location": f"{base}/a"}),
        "/private/x": (200, _page("Secret", []), "text/html", {}),
    }


@pytest.fixture()
def live_site():
    """A ``ThreadingHTTPServer`` on an OS-assigned loopback port."""
    state = {}

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            item = routes(state["base"]).get(self.path)
            if item is None:
                item = (404, "nope", "text/plain", {})
            code, body, ctype, extra = item
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for k, v in extra.items():
                if k != "chunked":
                    self.send_header(k, v)
            if extra.get("chunked"):
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for i in range(0, len(data), 100):
                    part = data[i:i + 100]
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(part), part))
                self.wfile.write(b"0\r\n\r\n")
            else:
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    state["base"] = f"http://127.0.0.1:{srv.server_address[1]}"
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield state["base"]
    srv.shutdown()
    srv.server_close()


def crawl(c, transport, base, path):
    store = c.CrawlStore(path)
    crawler = c.Crawler(store, c.Fetcher(transport), max_pages=10)
    asyncio.run(crawler.run(seeds=[base + "/"]))
    conn = sqlite3.connect(path)
    try:
        pages = sorted(conn.execute(
            "SELECT url, title, text, tue_eng_score FROM documents"))
    finally:
        conn.close()
    return pages, crawler


def test_both_crawlers_store_the_same_pages(live_site, tmp_path,
                                            monkeypatch):
    for var in ("HTTP_PROXY", "HTTPS_PROXY", "ALL_PROXY", "http_proxy",
                "https_proxy", "all_proxy"):
        monkeypatch.delenv(var, raising=False)
    want, ref_crawler = crawl(ref, HttpxTransport(timeout=5.0), live_site,
                              str(tmp_path / "ref.sqlite"))
    got, port_crawler = crawl(port, port.AsyncioTransport(timeout=5.0),
                              live_site, str(tmp_path / "port.sqlite"))
    assert got == want
    urls = {u for u, *_ in got}
    assert {live_site + p for p in ("/", "/a", "/b", "/c")} <= urls
    assert not any("/private" in u for u in urls)
    assert port_crawler.frontier.disallowed_urls == \
        ref_crawler.frontier.disallowed_urls
    for c in (port_crawler, ref_crawler):  # the robots decision
        assert not c.robots.allowed("127.0.0.1", live_site + "/private/x")
        assert c.robots.allowed("127.0.0.1", live_site + "/a")
    assert live_site + "/gone" in port_crawler.frontier.disallowed_urls
    assert port_crawler._robots_texts == ref_crawler._robots_texts
    assert "Gamma" in {t for _, t, *_ in got}  # the chunked body
    assert any("Tübingen" in text for _, _, text, _ in got)


@pytest.mark.parametrize("path", ["/", "/b", "/c", "/old", "/gone",
                                  "/robots.txt"])
def test_transport_answers_as_httpx(live_site, path, monkeypatch):
    """Status, the headers the fetcher reads, and the decoded text of
    each response equal httpx's; redirects are not followed."""
    for var in ("HTTP_PROXY", "HTTPS_PROXY", "ALL_PROXY", "http_proxy",
                "https_proxy", "all_proxy"):
        monkeypatch.delenv(var, raising=False)

    async def both():
        a, b = HttpxTransport(timeout=5.0), port.AsyncioTransport(timeout=5.0)
        try:
            return (await a.get(live_site + path),
                    await b.get(live_site + path))
        finally:
            await a.aclose()
            await b.aclose()

    (sa, ha, ta), (sb, hb, tb) = asyncio.run(both())
    assert sa == sb and ta == tb
    ha = {k.lower(): v for k, v in ha.items()}
    for k in ("content-type", "location", "retry-after"):
        assert ha.get(k) == hb.get(k), k


def test_transport_refuses_a_closed_port():
    async def get():
        return await port.AsyncioTransport(timeout=2.0).get(
            "http://127.0.0.1:9/x")

    with pytest.raises(OSError):
        asyncio.run(get())
