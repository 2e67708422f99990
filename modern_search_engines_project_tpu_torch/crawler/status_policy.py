"""Per-URL / per-domain failure policy (reference C13,
statusCodeManagement.py).

Behavioral parity with the reference's error handling, re-designed as one
policy object instead of a nest of global dicts:

  * exponential per-domain backoff x2, jittered, capped at 3600 s
    (statusCodeManagement.py:44-63),
  * per-status-code retry budgets and severity samples 0..1
    (statusCodeManagement.py:218-321): 2xx ok / connection-failure & 400
    budget 3 / other 4xx budget 2 / 429+999 budget 10 with backoff / 5xx
    budget 5 / 507-509 one-hour delay budget 3,
  * redirect-loop detection: 5 consecutive 3xx hops disallow the chain
    (statusCodeManagement.py:160-201),
  * Retry-After honored, numeric or date (statusCodeManagement.py:137-141),
  * domain kill switch: UTEMA(severity) > 3 with >= 3 recent samples
    disallows the whole domain (statusCodeManagement.py:311-319).

A copy of the reference package's ``crawler/status_policy.py``.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional, Tuple

from modern_search_engines_project_tpu_torch.crawler.helpers import (
    get_domain,
    parse_retry_after,
)
from modern_search_engines_project_tpu_torch.crawler.utema import Utema

MAX_DELAY = 3600.0
KILL_THRESHOLD = 3.0
KILL_MIN_SAMPLES = 3
REDIRECT_LOOP_LEN = 5

# severity calibration mirrors the reference's per-code samples
# (statusCodeManagement.py:218-321): benign codes ~0, throttling mid,
# server-side failure high.
def _classify(code: int) -> Tuple[int, float, float]:
    """code -> (retry_budget, severity, extra_delay_s)."""
    if 200 <= code < 300:
        return (0, 0.0, 0.0)
    if code in (429, 999):
        return (10, 2.0, 0.0)  # throttled: patient but noted
    if code in (507, 508, 509):
        return (3, 4.0, 3600.0)  # server out of resources: hour-long pause
    if 500 <= code < 600:
        return (5, 4.0, 0.0)
    if code == 400:
        return (3, 1.0, 0.0)
    if 400 <= code < 500:
        return (2, 1.0, 0.0)
    if 300 <= code < 400:
        return (5, 0.5, 0.0)
    if code <= 0:  # connection failure / timeout
        return (3, 3.0, 0.0)
    return (3, 1.0, 0.0)


@dataclasses.dataclass
class UrlState:
    failures: int = 0
    redirect_chain: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DomainState:
    delay: float = 0.0
    utema: Utema = dataclasses.field(default_factory=Utema)
    samples: int = 0


@dataclasses.dataclass
class Decision:
    action: str  # "ok" | "retry" | "drop" | "follow_redirect"
    delay: float = 0.0  # additional politeness delay for the domain
    kill_domain: bool = False
    reason: str = ""


class StatusPolicy:
    def __init__(self, rng: Optional[random.Random] = None):
        self.urls: Dict[str, UrlState] = {}
        self.domains: Dict[str, DomainState] = {}
        self.rng = rng or random.Random(0)

    def _backoff(self, domain: DomainState) -> float:
        """x2 exponential, jittered, capped (statusCodeManagement.py:44-63)."""
        base = domain.delay * 2 if domain.delay > 0 else 2.0
        base *= 1.0 + 0.25 * self.rng.random()
        domain.delay = min(base, MAX_DELAY)
        return domain.delay

    def record(
        self,
        url: str,
        code: int,
        retry_after: Optional[str] = None,
        location: Optional[str] = None,
        now: Optional[float] = None,
    ) -> Decision:
        now = time.time() if now is None else now
        domain = get_domain(url)
        dstate = self.domains.setdefault(domain, DomainState())
        ustate = self.urls.setdefault(url, UrlState())
        budget, severity, extra_delay = _classify(code)

        avg = dstate.utema.update(severity, now)
        dstate.samples += 1
        kill = (
            avg > KILL_THRESHOLD and dstate.utema.weight >= KILL_MIN_SAMPLES
        )

        if 200 <= code < 300:
            ustate.failures = 0
            ustate.redirect_chain.clear()
            dstate.delay = 0.0
            return Decision("ok", kill_domain=kill)

        if 300 <= code < 400 and location:
            ustate.redirect_chain.append(location)
            if len(ustate.redirect_chain) >= REDIRECT_LOOP_LEN:
                return Decision(
                    "drop",
                    kill_domain=kill,
                    reason="redirect loop",
                )
            return Decision("follow_redirect", kill_domain=kill)

        ustate.failures += 1
        delay = self._backoff(dstate) + extra_delay
        ra = parse_retry_after(retry_after)
        if ra is not None:
            delay = max(delay, min(ra, MAX_DELAY))
        if ustate.failures >= budget:
            return Decision(
                "drop",
                delay=delay,
                kill_domain=kill,
                reason=f"retry budget exhausted ({code})",
            )
        return Decision("retry", delay=delay, kill_domain=kill)

    def domain_delay(self, domain: str) -> float:
        st = self.domains.get(domain)
        return st.delay if st else 0.0
