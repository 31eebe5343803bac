"""Online prediction-drift detection per (kernel-kind, shape-bucket) (the
port's copy of ``repro.serve.telemetry.drift``, stdlib only).

The paper's value proposition is that measured tables *predict* runtime;
the successor-architecture studies (Hopper arXiv:2402.13499, Blackwell
arXiv:2507.10789) show those tables go stale per device generation.  This
module watches the live predicted-vs-measured pairs the engines stream
through telemetry and decides when a calibration no longer holds:

* samples are keyed ``(kind, bucket)`` — ``kind`` names the priced code
  path (``"decode"``, ``"chunk"``), ``bucket`` its shape class (batch
  width / chunk size), mirroring the tuning cache's (kernel,
  shape-bucket) key granularity;
* per key, a sliding window of ``(predicted_s, measured_s)`` pairs
  maintains the **median measured/predicted ratio** — median, not mean,
  so one preempted/compacted outlier step cannot fake a drift;
* when the windowed relative error ``|ratio - 1|`` exceeds ``gate``
  (default 0.10 — the SAME 10% bar the cost-model CLI enforces on its
  calibration round-trip, ``python -m repro_torch.core.costmodel
  --prediction-error``) with at least ``min_samples`` samples, a
  :class:`DriftEvent` fires carrying the correction ratio;
* firing clears that key's window and starts a ``cooldown`` (in samples)
  so the recalibration gets a fresh window of post-correction evidence
  before it can be judged again — "exactly one event per injected drift"
  is a property the sim tests pin.

The detector only *detects*; applying the correction (rescaling the
``Calibration``, invalidating tuning-cache entries) is
``serve.telemetry.recalibrate`` driven by the controller.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.serve.telemetry.metrics import quantile

DEFAULT_GATE = 0.10     # the cost-model CLI's prediction-error bar


@dataclasses.dataclass
class DriftEvent:
    """One detected calibration drift: predictions for ``kind``/``bucket``
    are off by ``ratio`` (median measured/predicted over the window)."""
    kind: str               # priced path: "decode" | "chunk"
    bucket: str             # shape bucket, e.g. "b4" / "c8"
    ratio: float            # median measured / predicted (>1: underpredict)
    error: float            # |ratio - 1|, the windowed relative error
    n_samples: int          # window size the verdict rests on
    predicted_s: float      # median predicted over the window
    measured_s: float       # median measured over the window

    @property
    def key(self) -> Tuple[str, str]:
        return (self.kind, self.bucket)

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class DriftDetector:
    """Windowed predicted-vs-measured watcher (see module docstring).

    ``gate``         relative-error threshold (default: the 10% CLI bar)
    ``window``       sliding-window length per key
    ``min_samples``  evidence floor before a verdict
    ``cooldown``     samples ignored per key after an event fires
    """

    def __init__(self, gate: float = DEFAULT_GATE, *, window: int = 8,
                 min_samples: int = 4, cooldown: int = 0):
        if not 0 < gate:
            raise ValueError("gate must be positive")
        if min_samples < 1 or window < min_samples:
            raise ValueError("need window >= min_samples >= 1")
        self.gate = gate
        self.window = window
        self.min_samples = min_samples
        self.cooldown = cooldown
        self._pairs: Dict[Tuple[str, str],
                          Deque[Tuple[float, float]]] = {}
        self._cool: Dict[Tuple[str, str], int] = {}
        self.events: List[DriftEvent] = []

    # ----- the read the runbook documents ------------------------------------

    def error(self, kind: str, bucket: str) -> Optional[float]:
        """Current windowed relative error for a key (None before
        ``min_samples`` pairs have arrived)."""
        pairs = self._pairs.get((kind, bucket), ())
        if len(pairs) < self.min_samples:
            return None
        return abs(self._ratio(pairs) - 1.0)

    @staticmethod
    def _ratio(pairs) -> float:
        return quantile([m / p for p, m in pairs], 0.5)

    # ----- the write side (controller feeds this) ----------------------------

    def observe(self, kind: str, bucket: str, predicted_s: float,
                measured_s: float) -> Optional[DriftEvent]:
        """Add one sample; returns a :class:`DriftEvent` when this sample
        tips the window past the gate.  Non-positive predictions are
        unpriceable (no cost model / zero-work step) and are skipped."""
        if predicted_s <= 0 or measured_s < 0:
            return None
        key = (kind, bucket)
        if self._cool.get(key, 0) > 0:
            self._cool[key] -= 1
            return None
        pairs = self._pairs.setdefault(key, deque(maxlen=self.window))
        pairs.append((predicted_s, measured_s))
        if len(pairs) < self.min_samples:
            return None
        ratio = self._ratio(pairs)
        error = abs(ratio - 1.0)
        if error <= self.gate:
            return None
        event = DriftEvent(
            kind=kind, bucket=bucket, ratio=ratio, error=error,
            n_samples=len(pairs),
            predicted_s=quantile([p for p, _ in pairs], 0.5),
            measured_s=quantile([m for _, m in pairs], 0.5))
        self.events.append(event)
        # fresh window + cooldown: the correction is judged on new
        # evidence only, and cannot be re-judged mid-refill
        pairs.clear()
        if self.cooldown:
            self._cool[key] = self.cooldown
        return event
