"""The telemetry controller: the one object an engine binds (the port's
copy of ``repro.serve.telemetry.control``).

``ServingEngine``/``PagedServingEngine`` accept ``telemetry=`` (a
:class:`TelemetryController`) and talk to it at exactly three points:

* ``begin_step()`` — once per engine iteration, *before* admission:
  refills the SLO token bucket (when an :class:`~.slo.SLO` is attached)
  and returns the step's admission budget, which the engines feed into
  the same arithmetic as the static ``step_budget_s`` gate;
* ``on_step(record)`` — once per productive iteration, with the filled
  :class:`~.metrics.StepRecord`: streams it into the sink, pays the
  bucket for the admitted work, feeds the SLO's AIMD loop with the
  measured latency, and feeds the drift detector;
* ``on_retire(request)`` — once per retirement: the per-request latency
  sample.

Drift attribution
-----------------
Only *attribution-unambiguous* steps feed the detector, so a drift event
names the table entry that actually drifted:

* a pure-decode step (decode dispatched, zero prefill units) is one
  ``("decode", "b<max_batch>")`` sample — predicted vs measured step;
* a pure-chunk step (prefill units, no decode) is one
  ``("chunk", "c<chunk_size>")`` sample at per-chunk granularity
  (both sides divided by the unit count);
* mixed steps are skipped: their error cannot be pinned on one entry.

When the detector fires, the controller *applies* the correction (unless
constructed with ``recalibrate=False``): a cost model exposing
``rescale(kind, factor)`` (the sim fake) is rescaled in place; a real
:class:`~repro_torch.core.costmodel.model.CostModel` goes through the
pure-data ``recalibrate.rescale_calibration`` path keyed on the drifted
step's bottleneck.  Either way the engine's prediction cache is
invalidated (``engine.set_cost_model``), stale tuning-cache entries are
dropped, the autotuner's pricing model is swapped, and a
:class:`RecalibrationEvent` lands in the sink.

Simulation
----------
Under the deterministic harness (``repro_torch.serve.sim``) the injected
clock is frozen within a step, so the engine-measured latency is 0;
``latency_model=`` (e.g. ``sim.work_latency_model``) replaces
``record.measured_s`` with a latency synthesized from the record's work
fields, closing the drift and SLO loops exactly as a wall clock would.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.serve.telemetry.drift import DriftDetector, DriftEvent
from repro_torch.serve.telemetry.metrics import (MetricsSink,
                                                 RequestRecord, StepRecord)
from repro_torch.serve.telemetry.slo import SLO, TokenBucket


@dataclasses.dataclass
class RecalibrationEvent:
    """One applied (or skipped) online recalibration, as stored in the
    sink's event ring and the snapshot's ``events`` list."""
    kind: str                   # drifted path: "decode" | "chunk"
    bucket: str                 # shape bucket, e.g. "b4"
    ratio: float                # median measured/predicted at detection
    error: float                # windowed relative error at detection
    n_samples: int              # drift-window size behind the verdict
    step: int                   # engine step the event fired on
    t_s: float                  # record timestamp at detection
    bottleneck: str             # Prediction.bottleneck of the drifted step
    applied: str                # "rescale" | "calibration" | "none"
    invalidated: int            # tuning-cache entries dropped
    calibration_before: str     # cost-model calibration name pre-swap
    calibration_after: str      # ... post-swap ("" on the rescale path)

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class TelemetryController:
    """Binds a metrics sink, drift detector, and SLO admission loop to
    one engine (see module docstring for the three touch points).

    ``slo=None`` leaves admission on the engine's static
    ``step_budget_s``; ``drift=None`` builds a default
    :class:`DriftDetector` (pass ``drift=False`` to disable detection);
    ``recalibrate=False`` detects and records drift without applying
    corrections (observe-only mode, the runbook's first rollout stage).
    """

    def __init__(self, sink: Optional[MetricsSink] = None, *,
                 drift=None, slo=None,
                 latency_model: Optional[Callable[[StepRecord], float]]
                 = None,
                 recalibrate: bool = True):
        self.sink = sink if sink is not None else MetricsSink()
        self.detector: Optional[DriftDetector]
        if drift is False:
            self.detector = None
        else:
            self.detector = drift if drift is not None else DriftDetector()
        # slo: an SLO (wrapped in a default TokenBucket), a pre-built
        # TokenBucket (custom rate/burst), or None (static budget)
        if slo is None:
            self.slo, self.bucket = None, None
        elif isinstance(slo, TokenBucket):
            self.slo, self.bucket = slo.slo, slo
        elif isinstance(slo, SLO):
            self.slo, self.bucket = slo, TokenBucket(slo)
        else:
            raise TypeError(f"slo must be an SLO or TokenBucket, "
                            f"got {type(slo).__name__}")
        self.latency_model = latency_model
        self.recalibrate = recalibrate
        self.engine = None
        self.engine_name = ""
        self._decode_bucket = ""
        self._chunk_bucket = ""
        self.recalibrations: List[RecalibrationEvent] = []

    # ----- engine binding ----------------------------------------------------

    def bind(self, engine) -> None:
        """Called by the engine's ``__init__``; one controller drives one
        engine (the drift buckets are derived from its shapes)."""
        if self.engine is not None and self.engine is not engine:
            raise ValueError("TelemetryController is already bound to an "
                             "engine; use one controller per engine")
        self.engine = engine
        self.engine_name = ("paged" if "Paged" in type(engine).__name__
                            else "slot")
        self._decode_bucket = f"b{engine.max_batch}"
        if hasattr(engine, "chunk_size"):
            self._chunk_bucket = f"c{engine.chunk_size}"

    # ----- the three engine touch points -------------------------------------

    def begin_step(self) -> Optional[float]:
        """Refill and return the SLO admission budget for this step, or
        None when no SLO is attached (engine falls back to its static
        ``step_budget_s``)."""
        if self.bucket is None:
            return None
        return self.bucket.begin_step()

    def on_step(self, record: StepRecord) -> None:
        if self.latency_model is not None:
            record.measured_s = float(self.latency_model(record))
        self.sink.record_step(record)
        if self.bucket is not None:
            self.bucket.spend(record.predicted_s)
            self.bucket.observe(record.measured_s)
        if self.detector is not None:
            self._feed_drift(record)

    def on_retire(self, req) -> None:
        self.sink.record_request(RequestRecord(
            engine=self.engine_name, rid=req.rid,
            submitted_s=req.submitted_s, finished_s=req.finished_s,
            latency_s=req.finished_s - req.submitted_s,
            prompt_len=len(req.prompt), n_tokens=len(req.tokens)))

    # ----- drift -> recalibration --------------------------------------------

    def _feed_drift(self, record: StepRecord) -> None:
        """Feed only attribution-unambiguous samples (module docstring)."""
        if record.decode_ran and record.n_prefill_units == 0:
            event = self.detector.observe(
                "decode", self._decode_bucket,
                record.predicted_decode_s, record.measured_s)
        elif (not record.decode_ran and record.n_prefill_units > 0
              and self._chunk_bucket):
            n = record.n_prefill_units
            event = self.detector.observe(
                "chunk", self._chunk_bucket,
                record.predicted_s / n, record.measured_s / n)
        else:
            return
        if event is not None:
            self._apply(event, record)

    def _apply(self, drift: DriftEvent, record: StepRecord) -> None:
        """Turn a drift verdict into a live cost-model correction."""
        applied, invalidated = "none", 0
        cal_before = cal_after = ""
        engine, cm = self.engine, getattr(self.engine, "cost_model", None)
        if self.recalibrate and engine is not None and cm is not None:
            if hasattr(cm, "rescale"):
                # sim fakes (and any model exposing the protocol):
                # one in-place table multiply
                cm.rescale(drift.kind, drift.ratio)
                engine.set_cost_model(cm)
                applied = "rescale"
                cal_before = getattr(getattr(cm, "cal", None), "name", "")
            else:
                from repro_torch.serve.telemetry.recalibrate import \
                    recalibrated_cost_model
                cal_before = cm.cal.name
                cm = recalibrated_cost_model(cm, drift.ratio,
                                             bottleneck=record.bottleneck)
                cal_after = cm.cal.name
                engine.set_cost_model(cm)
                applied = "calibration"
            invalidated = self._invalidate_tuning(cm, cal_before or None)
        event = RecalibrationEvent(
            kind=drift.kind, bucket=drift.bucket, ratio=drift.ratio,
            error=drift.error, n_samples=drift.n_samples,
            step=record.step, t_s=record.t_s,
            bottleneck=record.bottleneck, applied=applied,
            invalidated=invalidated, calibration_before=cal_before,
            calibration_after=cal_after)
        self.recalibrations.append(event)
        self.sink.record_event(event)

    def _invalidate_tuning(self, new_cm, calibration_id) -> int:
        """Configs ranked under the drifted calibration are stale: drop
        them and point the autotuner at the corrected model."""
        tuner = getattr(self.engine, "autotuner", None)
        if tuner is None:
            return 0
        from repro_torch.serve.telemetry.recalibrate import \
            invalidate_tuning_entries
        n = 0
        if getattr(tuner, "cache", None) is not None:
            n = invalidate_tuning_entries(tuner.cache,
                                          calibration_id=calibration_id)
        tuner.cost_model = new_cm
        return n
