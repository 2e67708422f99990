"""HTML -> (title, main text, outgoing links) extraction (reference C17).

Re-designed on lxml (C-speed, already the reference's underlying parser via
BeautifulSoup) with a stdlib ``html.parser`` fallback.  Same behavioral
contract as ``crawler/html_parser.py``: title from <title> else first <h1>;
boilerplate containers stripped (nav/header/footer/script/style/aside and
ad-ish classes); main-content preference (<main>, [role=main], <article>,
#content/.content) before falling back to <body>; whitespace normalized;
links from <a href> (plus XML <link>/<enclosure>), resolved absolute,
HTML-unescaped, sitemap URLs dropped.

A copy of the reference package's ``crawler/html_parser.py``.  The two
routes extract different text from the same page; where lxml is not
installed ``parse_html`` takes the ``html.parser`` route.
"""

from __future__ import annotations

import html as html_mod
import re
from typing import List, Optional, Tuple
from urllib.parse import urljoin

from modern_search_engines_project_tpu_torch.crawler.helpers import is_sitemap_url

_WS_RE = re.compile(r"\s+")
_STRIP_TAGS = {
    "script", "style", "noscript", "nav", "header", "footer", "aside",
    "form", "iframe", "svg", "template",
}
_AD_CLASS_RE = re.compile(r"(^|\s|-)(ad|ads|advert|banner|cookie|popup)(\s|-|$)")
_MAIN_XPATHS = [
    "//main",
    "//*[@role='main']",
    "//article",
    "//*[@id='content']",
    "//*[contains(concat(' ', normalize-space(@class), ' '), ' content ')]",
]


def _clean_text(s: str) -> str:
    return _WS_RE.sub(" ", s).strip()


def parse_html(
    raw: str, base_url: str
) -> Tuple[str, str, List[str]]:
    """returns (title, text, links)."""
    try:
        return _parse_lxml(raw, base_url)
    except Exception:
        return _parse_stdlib(raw, base_url)


def _parse_lxml(raw: str, base_url: str):
    from lxml import html as lhtml

    doc = lhtml.fromstring(raw)

    # title: <title> else first <h1>
    title = ""
    t = doc.xpath("//title/text()")
    if t:
        title = _clean_text(t[0])
    if not title:
        h1 = doc.xpath("//h1")
        if h1:
            title = _clean_text(h1[0].text_content())

    # links before stripping (nav links still count for the frontier)
    links: List[str] = []
    seen = set()
    for el, attr in (("a", "href"), ("link", "href"), ("enclosure", "url")):
        for node in doc.xpath(f"//{el}[@{attr}]"):
            href = html_mod.unescape(node.get(attr) or "").strip()
            if not href or href.startswith(("javascript:", "mailto:", "#")):
                continue
            absu = urljoin(base_url, href)
            if not absu.startswith(("http://", "https://")):
                continue
            if is_sitemap_url(absu):
                continue
            if absu not in seen:
                seen.add(absu)
                links.append(absu)

    # strip boilerplate
    for node in doc.xpath(
        "|".join(f"//{t}" for t in sorted(_STRIP_TAGS))
    ):
        parent = node.getparent()
        if parent is not None:
            parent.remove(node)
    for node in doc.xpath("//*[@class]"):
        if _AD_CLASS_RE.search(node.get("class") or ""):
            parent = node.getparent()
            if parent is not None:
                parent.remove(node)

    # main-content preference
    text = ""
    for xp in _MAIN_XPATHS:
        nodes = doc.xpath(xp)
        if nodes:
            text = _clean_text(nodes[0].text_content())
            if len(text) > 100:
                break
    if len(text) <= 100:
        body = doc.xpath("//body")
        text = _clean_text((body[0] if body else doc).text_content())
    return title, text, links


def _parse_stdlib(raw: str, base_url: str):
    from html.parser import HTMLParser

    class P(HTMLParser):
        def __init__(self):
            super().__init__(convert_charrefs=True)
            self.title_parts: List[str] = []
            self.text_parts: List[str] = []
            self.links: List[str] = []
            self._skip = 0
            self._in_title = False

        def handle_starttag(self, tag, attrs):
            if tag in _STRIP_TAGS:
                self._skip += 1
            if tag == "title":
                self._in_title = True
            if tag in ("a", "link"):
                for k, v in attrs:
                    if k == "href" and v:
                        self.links.append(urljoin(base_url, v.strip()))

        def handle_endtag(self, tag):
            if tag in _STRIP_TAGS and self._skip > 0:
                self._skip -= 1
            if tag == "title":
                self._in_title = False

        def handle_data(self, data):
            if self._in_title:
                self.title_parts.append(data)
            elif self._skip == 0:
                self.text_parts.append(data)

    p = P()
    p.feed(raw)
    title = _clean_text("".join(p.title_parts))
    text = _clean_text(" ".join(p.text_parts))
    links = [
        l
        for l in dict.fromkeys(p.links)
        if l.startswith(("http://", "https://")) and not is_sitemap_url(l)
    ]
    return title, text, links
