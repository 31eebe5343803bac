"""Production telemetry for the port's serving engines: metrics, drift
detection, online cost-model recalibration, and SLO-aware admission (the
port's copy of ``repro.serve.telemetry``).

The observability-and-control layer above ``ServingEngine`` and
``PagedServingEngine``.  An engine constructed with
``telemetry=TelemetryController(...)`` streams one
:class:`~.metrics.StepRecord` per iteration and one
:class:`~.metrics.RequestRecord` per retirement into a bounded
:class:`~.metrics.MetricsSink`; the controller watches
predicted-vs-measured step time per (kernel-kind, shape-bucket)
(:class:`~.drift.DriftDetector`), rescales the cost model live when the
10% gate is breached (``recalibrate``), and can replace the static
``step_budget_s`` admission gate with a p99-targeting token bucket
(:class:`~.slo.SLO` / :class:`~.slo.TokenBucket`).

Docs: ``docs/ops-runbook.md`` (reading the metrics, responding to drift,
setting SLOs), ``docs/reference/metrics.md`` (the field-by-field schema,
CI-checked against :data:`~.metrics.STEP_FIELDS`).  The records keep the
reference's field names and snapshot kind and version, so one document
describes both packages and a snapshot written by either loads in the
other.

Import note: :mod:`~.metrics`, :mod:`~.drift` and :mod:`~.slo` are
stdlib-only; torch is touched only by the sim scenarios and the CLI
smoke, which import the engines.
"""
from repro_torch.serve.telemetry.control import (RecalibrationEvent,
                                                 TelemetryController)
from repro_torch.serve.telemetry.drift import DriftDetector, DriftEvent
from repro_torch.serve.telemetry.metrics import (REQUEST_FIELDS,
                                                 STEP_FIELDS, MetricsSink,
                                                 RequestRecord, StepRecord,
                                                 load_snapshot,
                                                 validate_snapshot)
from repro_torch.serve.telemetry.recalibrate import (
    invalidate_tuning_entries, recalibrated_cost_model, rescale_calibration)
from repro_torch.serve.telemetry.slo import SLO, TokenBucket

__all__ = [
    "SLO",
    "DriftDetector",
    "DriftEvent",
    "MetricsSink",
    "RecalibrationEvent",
    "RequestRecord",
    "StepRecord",
    "STEP_FIELDS",
    "REQUEST_FIELDS",
    "TelemetryController",
    "TokenBucket",
    "invalidate_tuning_entries",
    "load_snapshot",
    "recalibrated_cost_model",
    "rescale_calibration",
    "validate_snapshot",
]
