"""The metrics pipeline: per-step / per-request records, a bounded ring
sink, and the schema-versioned snapshot + JSON-lines export formats (the
port's copy of ``repro.serve.telemetry.metrics``: the same record fields,
snapshot kind and version, so a snapshot written by either package loads
in the other and one reference doc describes both).

Both engines (``serve.engine``) build one :class:`StepRecord` per engine
iteration and one :class:`RequestRecord` per retirement and stream them
into a :class:`MetricsSink` (via ``serve.telemetry.TelemetryController``)
— the sink is a fixed-capacity ring buffer, so a long-running serving
process holds a bounded window of recent records, never an unbounded log.

Two on-disk forms, both documented in ``docs/reference/metrics.md``:

* **snapshot** — one schema-versioned JSON document (``kind:
  "telemetry_snapshot"``, like the campaign results and the autotune
  cache), carrying the current ring contents, every recalibration event,
  and a summary block (latency quantiles, drift error, totals).
  ``load_snapshot`` refuses kind-less or newer-versioned JSON loudly —
  the same discipline as ``autotune.cache``.
* **JSON lines** — ``export_jsonl`` writes one tagged object per line
  (``{"record": "step"|"request"|"event", ...}``), the append-friendly
  form a log shipper tails.

The field tables (:data:`STEP_FIELDS`, :data:`REQUEST_FIELDS`) are the
single source of truth for the metrics reference doc:
``python -m repro_torch.serve.telemetry checkdocs`` fails CI when a field
here is missing from ``docs/reference/metrics.md``.

This module is deliberately stdlib-only (no torch): the docs-check CI job
and log tooling import it without paying accelerator-runtime startup.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from collections import deque
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

SNAPSHOT_KIND = "telemetry_snapshot"
SNAPSHOT_VERSION = 1


@dataclasses.dataclass
class Field:
    """One schema row: the unit and provenance of a record field."""
    name: str
    type: str
    unit: str
    engines: str        # "slot", "paged", or "both"
    description: str


@dataclasses.dataclass
class StepRecord:
    """One engine iteration, as the engines report it.

    ``predicted_*`` fields are 0.0 when the engine has no cost model;
    ``measured_s`` is the wall (or injected-clock) duration of the
    iteration.  Counter fields (``host_syncs`` .. ``deferred``) are
    cumulative engine-lifetime values — consumers diff consecutive
    records for rates.  ``n_prefill_units`` is per-step: whole prompts
    admitted (slot engine) or prefill chunks run (paged engine) in this
    iteration.
    """
    engine: str                 # "slot" | "paged"
    step: int                   # stats.steps after this iteration
    t_s: float                  # clock.time() at record emission
    n_active: int               # rows/slots occupied at dispatch
    queue_depth: int            # requests waiting (not yet placed)
    predicted_s: float          # planned iteration time (decode+prefill)
    predicted_decode_s: float   # the decode-step component of the plan
    measured_s: float           # measured iteration wall time
    decode_ran: bool            # a batched decode was dispatched
    n_prefill_units: int        # prompts (slot) / chunks (paged) this step
    bottleneck: str             # decode Prediction.bottleneck ("" w/o model)
    budget_s: float             # effective admission budget (0.0 ungated)
    host_syncs: int             # cumulative device->host syncs (_sync)
    table_uploads: int          # cumulative block-table uploads (paged)
    blocks_in_use: int          # allocated pool blocks now (paged; 0 slot)
    n_blocks: int               # pool size (paged; 0 slot)
    decoded_tokens: int         # cumulative delivered tokens
    preemptions: int            # cumulative evictions (paged)
    deferred: int               # cumulative budget-deferred admissions
    kernel_splits: int          # tuned split-KV factor (paged; 0 slot)
    integrity_failures: int = 0  # cumulative corrupted-step drains dropped


@dataclasses.dataclass
class RequestRecord:
    """One retired request: the per-request latency sample."""
    engine: str                 # "slot" | "paged"
    rid: int                    # request id
    submitted_s: float          # clock.time() at submit
    finished_s: float           # clock.time() at retirement
    latency_s: float            # finished - submitted
    prompt_len: int             # prompt tokens
    n_tokens: int               # generated tokens delivered


def _fields(cls, meta: Dict[str, Tuple[str, str, str]]) -> List[Field]:
    """Zip the dataclass fields with their (unit, engines, description)
    rows; a KeyError here means a record field was added without schema
    metadata — exactly the gap the docs check exists to catch."""
    out = []
    for f in dataclasses.fields(cls):
        unit, engines, desc = meta[f.name]
        out.append(Field(f.name, f.type if isinstance(f.type, str)
                         else f.type.__name__, unit, engines, desc))
    return out


# (unit, emitting engines, description) per record field — the one table
# docs/reference/metrics.md must mirror (checked by `checkdocs`)
_STEP_META = {
    "engine": ("-", "both", "emitting engine: 'slot' or 'paged'"),
    "step": ("count", "both", "engine step counter after this iteration"),
    "t_s": ("s", "both", "clock.time() at record emission"),
    "n_active": ("count", "both", "occupied rows/slots at dispatch"),
    "queue_depth": ("count", "both", "requests waiting, not yet placed"),
    "predicted_s": ("s", "both",
                    "planned iteration time (decode + prefill units)"),
    "predicted_decode_s": ("s", "both",
                           "decode-step component of the plan"),
    "measured_s": ("s", "both", "measured iteration wall time"),
    "decode_ran": ("bool", "both", "a batched decode was dispatched"),
    "n_prefill_units": ("count", "both",
                        "prompts (slot) / chunks (paged) this step"),
    "bottleneck": ("-", "both",
                   "decode Prediction.bottleneck; '' without a model"),
    "budget_s": ("s", "both", "effective admission budget; 0.0 ungated"),
    "host_syncs": ("count", "both", "cumulative device->host syncs"),
    "table_uploads": ("count", "paged",
                      "cumulative block-table host->device uploads"),
    "blocks_in_use": ("blocks", "paged", "allocated pool blocks now"),
    "n_blocks": ("blocks", "paged", "pool size"),
    "decoded_tokens": ("tokens", "both", "cumulative delivered tokens"),
    "preemptions": ("count", "paged", "cumulative evictions"),
    "deferred": ("count", "both", "cumulative budget-deferred admissions"),
    "kernel_splits": ("count", "paged",
                      "resolved split-KV flash-decoding factor from the "
                      "tuning cache (1 = unsplit; 0 on the slot engine)"),
    "integrity_failures": ("count", "both",
                           "cumulative fused-step drains dropped by the "
                           "token-echo integrity probe (0 healthy)"),
}
_REQUEST_META = {
    "engine": ("-", "both", "emitting engine: 'slot' or 'paged'"),
    "rid": ("-", "both", "request id"),
    "submitted_s": ("s", "both", "clock.time() at submit"),
    "finished_s": ("s", "both", "clock.time() at retirement"),
    "latency_s": ("s", "both", "finished_s - submitted_s"),
    "prompt_len": ("tokens", "both", "prompt tokens"),
    "n_tokens": ("tokens", "both", "generated tokens delivered"),
}

STEP_FIELDS: List[Field] = _fields(StepRecord, _STEP_META)
REQUEST_FIELDS: List[Field] = _fields(RequestRecord, _REQUEST_META)


def schema_field_names() -> List[str]:
    """Every field name the reference doc must carry a row for."""
    return sorted({f.name for f in STEP_FIELDS} |
                  {f.name for f in REQUEST_FIELDS})


def quantile(xs: Iterable[float], q: float) -> float:
    """Nearest-rank-with-interpolation quantile of a finite sample
    (0 on empty input) — the p50/p99 the summary and the SLO loop use."""
    vals = sorted(xs)
    if not vals:
        return 0.0
    pos = q * (len(vals) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


class MetricsSink:
    """Bounded ring buffer of step / request / event records.

    ``capacity`` bounds each ring independently; the oldest records fall
    off first.  ``events`` (recalibrations) are kept in full up to the
    same cap — they are rare by construction (drift gate + cooldown).

    ``stream_path`` turns on the incremental append-and-flush JSONL mode
    for crash post-mortems: every record is ALSO written to the stream
    file the moment it is recorded — one ``{"record": ...}``-tagged line
    per record, the same format as :meth:`export_jsonl`, appended with a
    single ``write`` call and flushed — so the tail of a replica that
    dies mid-step survives on disk even though the process never reached
    an explicit export.  (One line per ``write`` keeps lines atomic on
    POSIX appends; a torn final line can only be the crash instant
    itself, which is exactly what a post-mortem wants to see.)
    """

    def __init__(self, capacity: int = 4096,
                 stream_path: "os.PathLike | str | None" = None):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._steps: deque = deque(maxlen=capacity)
        self._requests: deque = deque(maxlen=capacity)
        self._events: deque = deque(maxlen=capacity)
        # lifetime totals survive ring eviction
        self.total_steps = 0
        self.total_requests = 0
        self.total_events = 0
        self._stream = None
        self.stream_path: Optional[Path] = None
        if stream_path is not None:
            self.open_stream(stream_path)

    # ----- incremental stream ------------------------------------------------

    def open_stream(self, path: "os.PathLike | str") -> Path:
        """Start (or redirect) the append-and-flush JSONL stream."""
        self.close_stream()
        out = Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        self._stream = out.open("a")
        self.stream_path = out
        return out

    def close_stream(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    def stream_note(self, obj: Dict[str, Any]) -> None:
        """Append one arbitrary tagged line to the stream (no ring entry)
        — e.g. the cluster supervisor's dead-replica tag."""
        self._write_line(obj)

    def _write_line(self, obj: Dict[str, Any]) -> None:
        if self._stream is None:
            return
        self._stream.write(json.dumps(obj) + "\n")   # one atomic append
        self._stream.flush()

    # ----- write side --------------------------------------------------------

    def record_step(self, rec: StepRecord) -> None:
        self._steps.append(rec)
        self.total_steps += 1
        self._write_line({"record": "step", **dataclasses.asdict(rec)})

    def record_request(self, rec: RequestRecord) -> None:
        self._requests.append(rec)
        self.total_requests += 1
        self._write_line({"record": "request", **dataclasses.asdict(rec)})

    def record_event(self, event) -> None:
        """``event`` is any dataclass with an ``as_dict()`` (the
        controller's ``RecalibrationEvent``)."""
        self._events.append(event)
        self.total_events += 1
        self._write_line({"record": "event", **event.as_dict()})

    # ----- read side ---------------------------------------------------------

    def steps(self) -> List[StepRecord]:
        return list(self._steps)

    def requests(self) -> List[RequestRecord]:
        return list(self._requests)

    def events(self) -> list:
        return list(self._events)

    def summary(self) -> Dict[str, Any]:
        """The at-a-glance health block the ops runbook documents."""
        steps = self.steps()
        reqs = self.requests()
        meas = [s.measured_s for s in steps]
        lat = [r.latency_s for r in reqs]
        errs = [abs(s.measured_s - s.predicted_s) / s.predicted_s
                for s in steps if s.predicted_s > 0]
        return {
            "steps": self.total_steps,
            "requests": self.total_requests,
            "recalibrations": self.total_events,
            "step_p50_s": quantile(meas, 0.50),
            "step_p99_s": quantile(meas, 0.99),
            "request_p50_s": quantile(lat, 0.50),
            "request_p99_s": quantile(lat, 0.99),
            "mean_abs_pred_err": (sum(errs) / len(errs)) if errs else 0.0,
            "window": len(steps),
        }

    # ----- snapshot (schema-versioned document) ------------------------------

    def snapshot(self) -> Dict[str, Any]:
        return {
            "kind": SNAPSHOT_KIND,
            "version": SNAPSHOT_VERSION,
            "capacity": self.capacity,
            "schema": {
                "step": [dataclasses.asdict(f) for f in STEP_FIELDS],
                "request": [dataclasses.asdict(f) for f in REQUEST_FIELDS],
            },
            "steps": [dataclasses.asdict(s) for s in self._steps],
            "requests": [dataclasses.asdict(r) for r in self._requests],
            "events": [e.as_dict() for e in self._events],
            "summary": self.summary(),
        }

    def save(self, path: "os.PathLike | str") -> Path:
        out = Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self.snapshot(), indent=1, sort_keys=True))
        os.replace(tmp, out)
        return out

    # ----- JSON lines export -------------------------------------------------

    def export_jsonl(self, path: "os.PathLike | str") -> Path:
        """One tagged JSON object per line, in ring order: the
        shipper-friendly export (append a file per snapshot interval)."""
        out = Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("w") as fh:
            for s in self._steps:
                fh.write(json.dumps({"record": "step",
                                     **dataclasses.asdict(s)}) + "\n")
            for r in self._requests:
                fh.write(json.dumps({"record": "request",
                                     **dataclasses.asdict(r)}) + "\n")
            for e in self._events:
                fh.write(json.dumps({"record": "event",
                                     **e.as_dict()}) + "\n")
        return out


def validate_snapshot(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Refuse non-snapshot / newer-versioned JSON loudly (the
    ``autotune.cache`` discipline: pointing tooling at the wrong artifact
    must never be silently accepted)."""
    if not isinstance(doc, dict):
        raise ValueError("telemetry snapshot must be a JSON object")
    if doc.get("kind") != SNAPSHOT_KIND:
        raise ValueError(f"not a telemetry snapshot (kind="
                         f"{doc.get('kind')!r}, expected {SNAPSHOT_KIND!r})")
    version = doc.get("version", 0)
    if version > SNAPSHOT_VERSION:
        raise ValueError(
            f"telemetry snapshot schema v{version} is newer than supported "
            f"v{SNAPSHOT_VERSION}; upgrade the repo to read this file")
    return doc


def load_snapshot(path: "os.PathLike | str") -> Dict[str, Any]:
    return validate_snapshot(json.loads(Path(path).read_text()))
