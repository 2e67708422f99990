"""Crawler utilities: domains, prefix matching, Retry-After parsing.

Re-designed equivalents of reference ``crawler/helpers.py`` (C15): domain
extraction, longest-prefix robots rule matching, Retry-After header parsing
(numeric seconds or HTTP-date), sitemap-URL exclusion.

A copy of the reference package's ``crawler/helpers.py``.
"""

from __future__ import annotations

import re
import time
from email.utils import parsedate_to_datetime
from typing import Optional
from urllib.parse import urlparse

_SITEMAP_RE = re.compile(
    r"(sitemap[^/]*\.xml|sitemap\.txt|\.xml\.gz)$", re.IGNORECASE
)


def get_domain(url: str) -> str:
    """Hostname of a URL ('' if unparseable) — helpers.py:65-76 analog."""
    try:
        netloc = urlparse(url).netloc
        return netloc.split("@")[-1].split(":")[0].lower()
    except Exception:
        return ""


def is_sitemap_url(url: str) -> bool:
    return bool(_SITEMAP_RE.search(urlparse(url).path))


def longest_prefix_match(path: str, rules: list) -> int:
    """Length of the longest rule that is a prefix of path (0 if none) —
    the robots allow/disallow precedence rule (helpers.py:83-96)."""
    best = 0
    for rule in rules:
        if rule and path.startswith(rule):
            best = max(best, len(rule))
    return best


def parse_retry_after(value: Optional[str]) -> Optional[float]:
    """Retry-After: seconds (digits) or HTTP-date (helpers.py:103-115)."""
    if not value:
        return None
    value = value.strip()
    if value.isdigit():
        return float(value)
    try:
        dt = parsedate_to_datetime(value)
        return max(0.0, dt.timestamp() - time.time())
    except Exception:
        return None


def normalize_url(url: str) -> str:
    """Canonical form for dedup: strip scheme, query, fragment, trailing
    slash (preprocessor.ipynb cell 5 semantics)."""
    try:
        p = urlparse(url)
        path = p.path.rstrip("/")
        return f"{p.netloc.lower()}{path}"
    except Exception:
        return url
