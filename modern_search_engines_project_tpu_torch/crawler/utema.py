"""UTEMA: unbiased time-exponential moving average (reference C13 aux).

Implements the S/N recursion from Menth & Hauser, "On Moving Averages,
Histograms and Time-Dependent Rates for Online Measurement" (ICPE'17),
mirroring the reference's domain-health estimator (``crawler/UTEMA.py:51-86``):

  S_i = e^{-beta * dt} * S_{i-1} + x_i
  N_i = e^{-beta * dt} * N_{i-1} + 1
  A_i = S_i / N_i

with beta = 1/5 by default.  The average weights recent failure-severity
samples more, and is *unbiased* for irregular sample times — exactly what a
crawler's sporadic per-domain status codes need.

A copy of the reference package's ``crawler/utema.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class Utema:
    beta: float = 1.0 / 5.0
    s: float = 0.0
    n: float = 0.0
    last_t: Optional[float] = None

    def update(self, sample: float, t: float) -> float:
        if self.last_t is None:
            decay = 1.0
        else:
            dt = max(0.0, t - self.last_t)
            decay = math.exp(-self.beta * dt)
        self.s = decay * self.s + sample
        self.n = decay * self.n + 1.0
        self.last_t = t
        return self.average

    @property
    def average(self) -> float:
        return self.s / self.n if self.n > 0 else 0.0

    @property
    def weight(self) -> float:
        """Effective sample count (recency-discounted)."""
        return self.n
