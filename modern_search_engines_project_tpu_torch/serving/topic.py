"""Domain-derived topic labels for result rows (``/api/search``'s and the
C++ data plane's ``domain`` field), in a module of their own so the data
plane needs nothing of the HTTP control plane."""

from __future__ import annotations

import functools
import re
from urllib.parse import urlparse


@functools.lru_cache(maxsize=65536)
def extract_domain_topic(url: str) -> str:
    """Domain-derived topic label (search_api.py:168-201 parity).
    Memoized: popular doc urls recur in every response page."""
    if not url or url == "#":
        return "unknown"
    try:
        domain = urlparse(url).netloc.lower()
        domain = re.sub(r"^www\.", "", domain)
        parts = domain.split(".")
        main = parts[0] if len(parts) == 2 else (
            parts[-2] if len(parts) > 2 else domain
        )
        main = re.sub(r"[^a-zA-Z0-9-]", "", main)
        return main or "unknown"
    except Exception:
        return "unknown"
