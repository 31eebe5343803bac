"""SLO-aware admission: a token-bucket controller over step-time budget
(the port's copy of ``repro.serve.telemetry.slo``, stdlib only).

The engines alone gate admission on a *static* ``step_budget_s``: a
prefill (or chunk) is admitted iff its predicted cost fits the remaining
per-step budget.  That holds mean step time but says nothing about the tail —
a static budget is either so tight it starves throughput or so loose
that bursts blow the p99.  This module replaces the static gate with a
closed loop:

* the operator states intent as an :class:`SLO` — a target p99 step
  latency — instead of a per-step second count;
* a :class:`TokenBucket` meters *predicted seconds of admitted work*:
  each step refills ``rate`` seconds (capped at ``burst``), and the
  scheduler may only admit work whose predicted cost the bucket can
  pay.  Bursts are absorbed up to ``burst`` and then shed —
  **newest-first**, because both engines admit from the queue head and
  the paged engine's eviction policy protects the oldest request
  (forward-progress guarantee): overload never starves work already in
  flight;
* the loop closes with AIMD: every observation window the controller
  compares the measured p99 step latency against the target and adapts
  the refill rate — additive increase (``+increase``, fractional) while
  under target, multiplicative decrease (``*decrease``) when over.

``TokenBucket.budget_s`` is what the engines consume: it plugs into the
exact same arithmetic as the static ``step_budget_s`` (see
``ServingEngine._admit`` / ``ChunkedPrefillScheduler.plan(budget_s=)``),
so the whole deferral/eviction machinery is reused unchanged —
only the number it compares against becomes adaptive.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

from repro_torch.serve.telemetry.metrics import quantile


@dataclasses.dataclass(frozen=True)
class SLO:
    """Operator intent: hold step p99 at/under ``target_p99_s``.

    ``window``      steps per observation window (AIMD adapts per window)
    ``increase``    additive refill-rate increase per good window
                    (fraction of the target, e.g. 0.05 = +5%/window)
    ``decrease``    multiplicative refill-rate cut on a violated window
    ``min_rate_s``  refill-rate floor — keeps at least one small unit of
                    work admissible so the system drains instead of
                    deadlocking under a transient latency spike
    """
    target_p99_s: float
    window: int = 16
    increase: float = 0.05
    decrease: float = 0.7
    min_rate_s: float = 1e-6

    def __post_init__(self):
        if self.target_p99_s <= 0:
            raise ValueError("target_p99_s must be positive")
        if not 0 < self.decrease < 1:
            raise ValueError("decrease must be in (0, 1)")


class TokenBucket:
    """Meters predicted seconds of admitted work against an SLO.

    Per step: :meth:`begin_step` refills, the scheduler reads
    :attr:`budget_s` / calls :meth:`spend`, and the controller feeds the
    measured step latency back through :meth:`observe`.
    """

    def __init__(self, slo: SLO, *, rate_s: Optional[float] = None,
                 burst_factor: float = 2.0):
        self.slo = slo
        # start from the target itself: steady state admits about one
        # target-latency step's worth of work per step
        self.rate_s = slo.target_p99_s if rate_s is None else rate_s
        self.burst_factor = burst_factor
        self.tokens_s = self.rate_s          # start full: first step admits
        self._window: Deque[float] = deque(maxlen=slo.window)
        self.windows = 0                     # observation windows closed
        self.violations = 0                  # ... of which violated target
        self.rate_trace: List[float] = []    # rate_s after each window

    @property
    def burst_s(self) -> float:
        """Bucket capacity: the largest admissible single-step burst."""
        return self.rate_s * self.burst_factor

    @property
    def budget_s(self) -> float:
        """Admissible predicted seconds for the current step."""
        return self.tokens_s

    def begin_step(self) -> float:
        """Refill at the adapted rate (capped at burst); returns the
        step's budget."""
        self.tokens_s = min(self.tokens_s + self.rate_s, self.burst_s)
        return self.tokens_s

    def spend(self, predicted_s: float) -> None:
        """Pay for admitted work (floored at zero — prediction error must
        not drive the bucket negative and wedge admission)."""
        self.tokens_s = max(0.0, self.tokens_s - max(0.0, predicted_s))

    def tighten(self, factor: float) -> float:
        """Brownout: multiplicatively cut the admission rate (e.g. to the
        surviving-capacity fraction after a replica death) without
        waiting for a violation window — the AIMD loop then *earns* the
        rate back additively as the shrunk fleet proves it can hold the
        target.  Spills above the new burst ceiling are clipped so the
        very next step already admits at brownout rate.  Returns the new
        ``rate_s``."""
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"tighten factor must be in (0, 1], "
                             f"got {factor}")
        self.rate_s = max(self.slo.min_rate_s, self.rate_s * factor)
        self.tokens_s = min(self.tokens_s, self.burst_s)
        self.rate_trace.append(self.rate_s)
        return self.rate_s

    def observe(self, measured_s: float) -> None:
        """Feed one measured step latency; closes the AIMD loop once per
        ``slo.window`` observations."""
        self._window.append(measured_s)
        if len(self._window) < self.slo.window:
            return
        p99 = quantile(list(self._window), 0.99)
        self.windows += 1
        if p99 > self.slo.target_p99_s:
            self.violations += 1
            self.rate_s = max(self.slo.min_rate_s,
                              self.rate_s * self.slo.decrease)
        else:
            self.rate_s += self.slo.increase * self.slo.target_p99_s
        self.rate_trace.append(self.rate_s)
        self._window.clear()
