"""The port's crawler (``modern_search_engines_project_tpu_torch/crawler``)
against the reference's, on the CPU and offline.

Each case of the reference's ``tests/test_crawler.py`` (robots, UTEMA,
status policy, metric, frontier, both HTML parser routes, storage, the end
to end crawl over a fake site, resume) runs on both packages: the case's
own assertions hold for each, and the port's outputs equal the
reference's on the same inputs.  The HTML parser is held route by route
(lxml against lxml, ``html.parser`` against ``html.parser``): the routes
extract different text, and the card's machine has no lxml.  Time comes
in through each case's ``now`` arguments, and the status policy's jitter
is drawn from one seed on both sides.
"""

import asyncio
import dataclasses
import math
import random
import sqlite3

import pytest

import modern_search_engines_project_tpu.crawler as ref
import modern_search_engines_project_tpu_torch.crawler as port
from modern_search_engines_project_tpu.crawler import frontier as ref_frontier
from modern_search_engines_project_tpu.crawler import html_parser as ref_html
from modern_search_engines_project_tpu.crawler import metric as ref_metric
from modern_search_engines_project_tpu.crawler import preprocess as ref_pre
from modern_search_engines_project_tpu_torch.crawler import frontier as port_frontier
from modern_search_engines_project_tpu_torch.crawler import html_parser as port_html
from modern_search_engines_project_tpu_torch.crawler import metric as port_metric
from modern_search_engines_project_tpu_torch.crawler import preprocess as port_pre

PKGS = {"ref": (ref, ref_frontier, ref_html, ref_metric, ref_pre),
        "port": (port, port_frontier, port_html, port_metric, port_pre)}


def both(case, *args):
    """``case`` on the reference's modules and on the port's: the port's
    result, which must equal the reference's."""
    want = case(*PKGS["ref"], *args)
    got = case(*PKGS["port"], *args)
    assert got == want
    return got


# ---- robots -----------------------------------------------------------------

ROBOTS = {
    "basic_disallow": ("User-agent: *\nDisallow: /private/\n",
                       ["https://x.de/private/page", "https://x.de/public/page"],
                       [False, True]),
    "longest_match_allow_wins": (
        "User-agent: *\nDisallow: /a/\nAllow: /a/public/\n",
        ["https://x.de/a/public/page", "https://x.de/a/secret"], [True, False]),
    "agent_specific_group": (
        "User-agent: *\nDisallow: /\n\nUser-agent: mse-tpu-crawler\n"
        "Disallow: /internal/\n",
        ["https://x.de/page", "https://x.de/internal/x"], [True, False]),
    "crawl_delay_parsed": ("User-agent: *\nCrawl-delay: 7\n", [], []),
    "crawl_delay_below_default_honored": (
        "User-agent: *\nCrawl-delay: 0.1\n", [], []),
    "empty_robots_allows": (None, ["https://x.de/anything"], [True]),
    "multi_agent_header": ("User-agent: a\nUser-agent: *\nDisallow: /x/\n",
                           ["https://x.de/x/1"], [False]),
}
DELAYS = {"crawl_delay_parsed": 7.0, "crawl_delay_below_default_honored": 0.1,
          "empty_robots_allows": 1.5}


@pytest.mark.parametrize("name", sorted(ROBOTS))
def test_robots(name):
    text, urls, allowed = ROBOTS[name]

    def case(c, *_):
        r = c.parse_robots(text)
        return [r.allowed(u) for u in urls], r.crawl_delay, dataclasses.asdict(r)

    got, delay, _ = both(case)
    assert got == allowed
    if name in DELAYS:
        assert delay == DELAYS[name]


def test_robots_cache():
    def case(c, *_):
        cache = c.RobotsCache()
        cache.update("a.de", "User-agent: *\nDisallow: /b\nCrawl-delay: 0\n")
        return (cache.allowed("a.de", "https://a.de/b/1"),
                cache.allowed("a.de", "https://a.de/c"),
                cache.allowed("z.de", "https://z.de/b"), cache.delay("a.de"),
                cache.delay("z.de"))

    assert both(case) == (False, True, True, 0.0, 1.5)


# ---- UTEMA ------------------------------------------------------------------


def test_utema():
    def case(c, *_):
        u = c.Utema()
        first = u.update(2.0, t=0.0)
        v = c.Utema(beta=0.2)
        v.update(1.0, t=0.0)
        two = v.update(3.0, t=5.0)
        w = c.Utema(beta=0.2)
        w.update(5.0, t=0.0)
        return first, two, w.update(0.0, t=1000.0)

    first, two, old = both(case)
    d = math.exp(-0.2 * 5.0)
    assert first == 2.0
    assert abs(two - (d * 1.0 + 3.0) / (d + 1.0)) < 1e-12
    assert old < 0.01


# ---- status policy ----------------------------------------------------------


def record_all(c, calls):
    """Decisions of one ``StatusPolicy`` over ``calls`` (url, status,
    keyword arguments), its jitter drawn from one seed on both sides."""
    p = c.StatusPolicy(rng=random.Random(1234))
    out = [dataclasses.asdict(p.record(u, s, **kw)) for u, s, kw in calls]
    return out, p


POLICY = {
    "ok_resets": [("https://a.de/x", 500, {"now": 0.0}),
                  ("https://a.de/x", 200, {"now": 1.0})],
    "retry_budget_5xx": [("https://a.de/x", 503, {"now": float(i)})
                         for i in range(5)],
    "4xx_budget_2": [("https://a.de/x", 404, {"now": float(i)})
                     for i in range(2)],
    "backoff_doubles_and_caps": [("https://a.de/x", 429, {"now": float(i)})
                                 for i in range(9)],
    "retry_after_honored": [("https://a.de/x", 429,
                             {"retry_after": "120", "now": 0.0})],
    "redirect_loop_dropped": [
        ("https://a.de/x", 301, {"location": f"https://a.de/r{i}",
                                 "now": float(i)}) for i in range(4)
    ] + [("https://a.de/x", 301, {"location": "https://a.de/r5", "now": 9.0})],
    "domain_kill_switch": [(f"https://bad.de/{i}", 503, {"now": float(i)})
                           for i in range(4)],
    "connection_failures_and_507": [
        ("https://c.de/x", 0, {"now": 0.0}), ("https://c.de/x", 400,
                                             {"now": 1.0}),
        ("https://c.de/y", 507, {"now": 2.0}), ("https://c.de/y", 999,
                                               {"now": 3.0})],
}


@pytest.mark.parametrize("name", sorted(POLICY))
def test_status_policy(name):
    got = both(lambda c, *_: record_all(c, POLICY[name])[0])
    actions = [d["action"] for d in got]
    if name == "ok_resets":
        assert actions[-1] == "ok"
        assert record_all(port, POLICY[name])[1].urls[
            "https://a.de/x"].failures == 0
    elif name == "retry_budget_5xx":
        assert actions == ["retry"] * 4 + ["drop"]
    elif name == "4xx_budget_2":
        assert actions == ["retry", "drop"]
    elif name == "backoff_doubles_and_caps":
        delays = [d["delay"] for d in got]
        assert delays[1] > delays[0] and all(d <= 3600.0 * 1.26 for d in delays)
    elif name == "retry_after_honored":
        assert got[0]["delay"] >= 120
    elif name == "redirect_loop_dropped":
        assert actions == ["follow_redirect"] * 4 + ["drop"]
        assert "loop" in got[-1]["reason"]
    elif name == "domain_kill_switch":
        assert any(d["kill_domain"] for d in got)


def test_retry_after_parsing():
    def case(c, *_):
        return [c.parse_retry_after(v)
                for v in ("120", "0", "-5", "nonsense", None,
                          "Wed, 21 Oct 2015 07:28:00 GMT")]

    got = both(case)
    assert got[:2] == [120.0, 0.0] and got[-1] == 0.0  # a past date


# ---- metric -----------------------------------------------------------------

EN = ("The university is one of the oldest in the country and the students "
      "are happy with it.")
DE = ("Die Universität ist eine der ältesten im Land und die Studenten sind "
      "zufrieden damit.")
LISTING = ("Opening hours: Monday closed. Tickets available online. Castle "
           "tours daily. Great view. Student discounts available. Wheelchair "
           "accessible entrance. Guided visits hourly.")
DE2 = ("Die Öffnungszeiten der Universität werden nächste Woche geändert und "
       "die Studenten wurden bereits informiert.")
FR = ("L'université est l'une des plus anciennes du pays et les étudiants "
      "sont satisfaits de la qualité des cours.")
ES = ("La universidad es una de las más antiguas del país y los estudiantes "
      "están contentos con la calidad de los cursos.")
IT = ("L'università è una delle più antiche del paese e gli studenti sono "
      "soddisfatti della qualità dei corsi.")
RELEVANT = ("The University of Tuebingen is a research institute in "
            "Baden-Wuerttemberg on the Neckar river. Students enjoy punting "
            "and the campus. " * 3)
IRRELEVANT = "How to bake the best chocolate chip cookies at home. " * 5


def test_language_detectors():
    def case(c, f, h, m, p):
        return [(m.english_score(t), m.english_score(t, inconclusive=0.0),
                 m.trigram_english_score(t), m.is_probably_english(t))
                for t in (EN, DE, LISTING, DE2, FR, ES, IT)]

    rows = dict(zip(("en", "de", "listing", "de2", "fr", "es", "it"),
                    both(case)))
    assert rows["en"][0] > 0.5 and rows["de"][0] < 0.3
    assert rows["en"][2] > 0.5 and rows["de"][2] < 0.3
    assert rows["listing"][0] < 0.5 and rows["listing"][2] >= 0.5
    assert rows["listing"][3] and not rows["de2"][3]
    for k in ("fr", "es", "it"):
        assert rows[k][2] < 0.3 and rows[k][1] < 0.15


def test_relevance_scores():
    def case(c, *_):
        text = "Tuebingen university research institute on the Neckar. " * 5
        url = "https://uni-tuebingen.de/en/"
        return (c.tue_eng_score(RELEVANT, "https://uni-tuebingen.de/en/research"),
                c.tue_eng_score(IRRELEVANT, "https://cookies.com/recipe"),
                [c.tue_eng_score(text, url, linking_depth=d)
                 for d in (0, 4, 6)],
                c.tue_eng_score(text, url, incoming=9, domain_depth=2,
                                incoming_total_score=4.0),
                c.url_score("https://www.tuebingen.de/en/rathaus"),
                c.url_score("https://example.com/a/b/c/d/e"),
                c.text_score(RELEVANT), c.english_score(RELEVANT))

    rel, irr, depths, rescued, u1, u2, _, _ = both(case)
    assert rel > 0.5 > irr
    assert depths[0] > depths[1] > 0 and depths[2] == 0.0
    assert u1 > 0.6 and u2 <= 0.05


# ---- frontier ---------------------------------------------------------------


def frontier_cases(c, f, *_):
    out = {}
    fr = c.Frontier()
    out["dedup"] = (fr.add("https://a.de/x", now=0.0),
                    fr.add("https://a.de/x", now=0.0),
                    fr.meta["https://a.de/x"]["incoming"])
    fr = c.Frontier()
    for i in range(5):
        fr.add(f"https://a.de/{i}", now=0.0)
    fr.add("https://b.de/1", now=0.0)
    out["distinct"] = fr.pop_due(10, now=1.0)
    fr = c.Frontier()
    fr.add("https://a.de/x", when=100.0, now=0.0)
    out["future"] = (fr.pop_due(10, now=1.0), fr.pop_due(10, now=101.0))
    fr = c.Frontier()
    fr.add("https://a.de/x", now=0.0)
    fr.set_domain_delay("a.de", 50.0)
    out["delay"] = (fr.pop_due(10, now=1.0), fr.pop_due(10, now=51.0))
    fr = c.Frontier()
    for u in ("https://a.de/1", "https://a.de/2", "https://b.de/1"):
        fr.add(u, now=0.0)
    fr.disallow_domain("a.de")
    out["purge"] = (len(fr), fr.add("https://a.de/3", now=0.0))
    fr = c.Frontier()
    fr.add("https://a.de/x", when=5.0, now=0.0, linking_depth=2)
    fr.disallow_domain("bad.de")
    state = fr.to_state()
    g = c.Frontier.from_state(state)
    out["roundtrip"] = (state, "https://a.de/x" in g,
                        g.meta["https://a.de/x"]["linking_depth"],
                        "bad.de" in g.disallowed_domains,
                        g.pop_due(10, now=6.0))
    fr = c.Frontier()
    for i in range(3000):
        fr.add(f"https://d{i % 3}.de/p{i}", now=0.0)
    out["deep"] = (fr.pop_due(100, now=1.0), fr.pop_due(100, now=1.0),
                   sum(fr.domain_pending.values()), fr.next_due_time())
    return out


def test_frontier():
    out = both(frontier_cases)
    assert out["dedup"] == (True, False, 2)
    assert {u.split("/")[2] for u, _ in out["distinct"]} == {"a.de", "b.de"}
    assert len(out["distinct"]) == 2
    assert out["future"][0] == [] and len(out["future"][1]) == 1
    assert out["delay"][0] == [] and len(out["delay"][1]) == 1
    assert out["purge"] == (1, False)
    assert out["roundtrip"][1:4] == (True, 2, True)
    assert len(out["roundtrip"][4]) == 1
    assert len(out["deep"][0]) == 3 and len(out["deep"][1]) == 3
    assert out["deep"][2] == 3000 - 6


def test_deep_frontier_does_not_drain(monkeypatch):
    """The port keeps the reference's two-level frontier: with far more due
    urls than domains, a round pops a handful of heap entries, not all."""
    import heapq as real_heapq

    f = port.Frontier()
    for i in range(10_000):
        f.add(f"https://d{i % 3}.de/p{i}", now=0.0)
    pops = {"n": 0}
    orig = real_heapq.heappop

    def counting_pop(h):
        pops["n"] += 1
        return orig(h)

    monkeypatch.setattr(port_frontier.heapq, "heappop", counting_pop)
    assert len(f.pop_due(100, now=1.0)) == 3
    assert pops["n"] <= 10


# ---- HTML parser ------------------------------------------------------------

HTML = """
<html><head><title> Tübingen Castle </title>
<script>var x = 1;</script></head>
<body><nav><a href="/nav">Nav</a></nav>
<main><h1>Castle</h1><p>The castle  overlooks the
Neckar river.</p><a href="/tour">tour</a>
<a href="https://other.de/page?x=1">other</a>
<a href="mailto:x@y.z">mail</a>
<a href="/sitemap.xml">sitemap</a></main>
<footer>© 2024</footer></body></html>
"""
PAGES = {
    "castle": (HTML, "https://www.tuebingen.de/"),
    "h1_title": ("<body><h1>Header Title</h1></body>", "https://x.de"),
    "ads_and_article": (
        '<html><head><title>A &amp; B</title></head><body>'
        '<div class="cookie-banner">accept cookies</div>'
        '<article>' + "Real article text about the Neckar. " * 5
        + '<a href="rel/link?a=1&amp;b=2">l</a>'
        '<a href="javascript:void(0)">j</a></article>'
        '<link href="/feed.rss"><aside>side</aside></body></html>',
        "https://news.de/2024/"),
    "no_main": ("<html><body><p>short</p><a href='x.html'>x</a>"
                "<a href='#top'>t</a></body></html>", "http://a.de/d/"),
}


@pytest.mark.parametrize("route", ["_parse_lxml", "_parse_stdlib"])
@pytest.mark.parametrize("page", sorted(PAGES))
def test_parser_routes(page, route):
    if route == "_parse_lxml":
        pytest.importorskip("lxml")
    raw, base = PAGES[page]
    got = both(lambda c, f, h, *_: getattr(h, route)(raw, base))
    title, text, links = got
    if page == "castle":
        assert title == "Tübingen Castle"
        assert "overlooks the Neckar river" in text
        assert "var x" not in text
        assert "https://www.tuebingen.de/tour" in links
        assert "https://other.de/page?x=1" in links
        assert not any("mailto" in u or "sitemap.xml" in u for u in links)
        if route == "_parse_lxml":
            assert "©" not in text
    if page == "h1_title" and route == "_parse_lxml":
        assert title == "Header Title"


def test_parse_html_takes_lxml_where_installed():
    """``parse_html`` is the lxml route where lxml imports, as the
    reference's is, and the stdlib route where it does not."""
    pytest.importorskip("lxml")
    raw, base = PAGES["castle"]
    assert port.parse_html(raw, base) == port_html._parse_lxml(raw, base)
    assert port.parse_html(raw, base) == ref.parse_html(raw, base)


def test_parse_html_falls_back_to_the_stdlib(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "lxml", None)
    raw, base = PAGES["castle"]
    assert port.parse_html(raw, base) == port_html._parse_stdlib(raw, base)
    assert port.parse_html(raw, base) == ref.parse_html(raw, base)


# ---- storage ----------------------------------------------------------------


def storage_case(c, f, h, m, p, tmp_path):
    store = c.CrawlStore(str(tmp_path / f"{c.__name__}.sqlite"))
    store.upsert_documents([
        {"url": "https://a.de/1", "title": "t1", "text": "x",
         "tue_eng_score": 0.9},
        {"url": "https://a.de/2", "title": "t2", "text": "y",
         "tue_eng_score": 0.2},
    ])
    n = store.n_documents()
    kept = [(d.doc_id, d.url, d.title, d.text)
            for d in store.iter_documents(min_score=0.5)]
    store.upsert_documents([{"url": "https://a.de/1", "title": "t1b",
                             "text": "z", "tue_eng_score": 0.9}])
    store.save_state({"frontier": {"meta": {"u": {"incoming": 1}}}})
    store.log_error("https://a.de/3", 404, "drop", 5.0)
    return (n, kept, store.n_documents(), store.load_state(),
            store.has_url("https://a.de/2"), store.has_url("https://a.de/9"))


def test_storage(tmp_path):
    n, kept, n2, state, has, hasnt = both(storage_case, tmp_path)
    assert n == 2 and n2 == 2 and len(kept) == 1
    assert kept[0][1] == "https://a.de/1"
    assert state["frontier"]["meta"]["u"]["incoming"] == 1
    assert has and not hasnt


# ---- merge ------------------------------------------------------------------


def merge_case(c, f, h, m, p, tmp_path):
    hist = c.CrawlStore(str(tmp_path / f"h_{c.__name__}.sqlite"))
    new = c.CrawlStore(str(tmp_path / f"n_{c.__name__}.sqlite"))
    hist.upsert_documents([{"url": "https://a.de/1/", "title": "h",
                            "text": EN}])
    new.upsert_documents([
        {"url": "http://a.de/1", "title": "dup", "text": EN},
        {"url": "https://b.de/x?q=1", "title": "b", "text": EN * 2},
        {"url": "https://b.de/x", "title": "b2", "text": EN},
        {"url": "https://c.de/", "title": "de", "text": DE2 * 3},
        {"url": "https://d.de/", "title": "short", "text": "kurz"},
    ])
    rep = p.merge_crawls(hist, new)
    return dataclasses.asdict(rep), [
        (d.url, d.title) for d in hist.iter_documents(min_score=-1.0)]


def test_merge_crawls(tmp_path):
    rep, docs = both(merge_case, tmp_path)
    assert rep["incoming"] == 5 and rep["dropped_duplicate_historical"] == 1
    assert rep["dropped_duplicate_batch"] == 1 and rep["dropped_language"] == 1
    assert rep["merged"] == 2 and len(docs) == 3


# ---- end to end over a fake site --------------------------------------------


class FakeTransport:
    """An in-memory website graph."""

    def __init__(self, pages, robots=None, statuses=None):
        self.pages = pages
        self.robots = robots or {}
        self.statuses = statuses or {}
        self.requests = []

    async def get(self, url):
        self.requests.append(url)
        if url.endswith("/robots.txt"):
            return 200, {}, self.robots.get(url.split("/")[2], "")
        if url in self.statuses:
            code, headers = self.statuses[url]
            return code, headers, ""
        if url in self.pages:
            return 200, {"content-type": "text/html"}, self.pages[url]
        return 404, {}, ""

    async def aclose(self):
        pass


def _page(title, links, extra=""):
    body = "".join(f'<a href="{u}">{u}</a>' for u in links)
    return (
        f"<html><head><title>{title}</title></head><body><main>"
        f"Tuebingen Tuebingen Tuebingen is a university town in Germany on "
        f"the Neckar river in Baden-Wuerttemberg in the Swabian hills. The "
        f"research institute and the faculty campus host a seminar and a "
        f"lecture for every professor. Stocherkahn punting starts at the "
        f"Marktplatz. {extra} {body}</main></body></html>"
    )


SITE = {
    "https://uni.de/a": _page("Uni A", ["https://uni.de/b", "https://other.de/c",
                                        "https://uni.de/moved"]),
    "https://uni.de/b": _page("Uni B", []),
    "https://other.de/c": _page("Other C", ["https://uni.de/blocked"]),
    "https://uni.de/new": _page("Uni New", []),
}
STATUSES = {"https://uni.de/moved": (301, {"Location": "https://uni.de/new"})}


def stored_pages(store):
    """Every stored page as (url, title, text, tueEngScore), sorted."""
    conn = sqlite3.connect(store.path)
    try:
        return sorted(conn.execute(
            "SELECT url, title, text, tue_eng_score FROM documents"))
    finally:
        conn.close()


def crawl(c, tmp_path, seeds, robots=None, max_pages=10, db="c"):
    """The crawl's stored pages (url, title, text, score) and requests."""
    transport = FakeTransport(SITE, robots, STATUSES)
    store = c.CrawlStore(str(tmp_path / f"{db}_{c.__name__}.sqlite"))
    crawler = c.Crawler(store, c.Fetcher(transport), max_pages=max_pages)
    crawler.robots.delay = lambda d: 0.0
    n = asyncio.run(crawler.run(seeds=seeds))
    docs = stored_pages(store)
    return n, docs, sorted(set(transport.requests)), store


@pytest.mark.parametrize("robots,seeds", [
    (None, ["https://uni.de/a"]),
    ({"uni.de": "User-agent: *\nDisallow: /b\n"}, ["https://uni.de/a"]),
    ({"uni.de": "User-agent: *\nDisallow: /b\n"},
     ["https://uni.de/b", "https://uni.de/a"]),
], ids=["stores_and_expands", "robots_disallow", "robots_pre_enqueued"])
def test_crawl_end_to_end(robots, seeds, tmp_path):
    outs = {k: crawl(PKGS[k][0], tmp_path, seeds, robots) for k in PKGS}
    assert outs["port"][:3] == outs["ref"][:3]
    n, docs, requests, _ = outs["port"]
    urls = {d[0] for d in docs}
    assert "https://uni.de/a" in urls and "https://other.de/c" in urls
    assert "https://uni.de/new" in urls  # the redirect was followed
    if robots:
        assert "https://uni.de/b" not in urls
    else:
        assert n >= 3 and "https://uni.de/b" in urls


def test_resume_after_stop(tmp_path):
    out = {}
    for k, (c, *_) in PKGS.items():
        _, _, _, store = crawl(c, tmp_path, ["https://uni.de/a"], max_pages=1,
                               db="r")
        assert store.load_state()
        n, docs, req, _ = crawl(c, tmp_path, ["https://ignored.de/seed"],
                                db="r")
        out[k] = docs, req
        urls = {d[0] for d in docs}
        assert "https://other.de/c" in urls or "https://uni.de/b" in urls
        assert not any("ignored.de" in u for u in urls)
    assert out["port"] == out["ref"]


def test_the_default_fetcher_needs_no_httpx(monkeypatch):
    """The port's ``Fetcher`` builds an ``AsyncioTransport`` by default;
    ``HttpxTransport`` stays for callers who pass one."""
    import sys

    monkeypatch.setitem(sys.modules, "httpx", None)
    f = port.Fetcher()
    assert isinstance(f._ensure_transport(), port.AsyncioTransport)
    from modern_search_engines_project_tpu_torch.crawler.fetch import (
        HttpxTransport,
    )

    with pytest.raises(ImportError):
        HttpxTransport()


def test_exports_match_the_reference():
    assert set(ref.__all__) <= set(port.__all__)
    assert set(port.__all__) - set(ref.__all__) == {"AsyncioTransport"}
    assert port.DEFAULT_SEEDS == ref.DEFAULT_SEEDS


def test_crawler_cli_resumes(tmp_path, monkeypatch):
    """``python -m ...crawler`` over the fake site: the crawl stores its
    pages and checkpoints; a second run resumes from the checkpoint (an
    empty frontier: nothing more to fetch) and ignores its seeds."""
    from modern_search_engines_project_tpu_torch.crawler import __main__ as cli

    zero = "User-agent: *\nCrawl-delay: 0\n"
    robots = {"uni.de": zero, "other.de": zero}
    monkeypatch.setattr(port.main, "Fetcher", lambda *a, **k: port.Fetcher(
        FakeTransport(SITE, robots, STATUSES)))
    db = str(tmp_path / "cli.sqlite")
    cli.main(["--db", db, "--seeds", "https://uni.de/a"])
    store = port.CrawlStore(db)
    first = sorted(d.url for d in store.iter_documents(min_score=-1.0))
    assert "https://other.de/c" in first and store.load_state()
    cli.main(["--db", db, "--seeds", "https://ignored.de/x"])
    again = sorted(d.url for d in store.iter_documents(min_score=-1.0))
    assert again == first
