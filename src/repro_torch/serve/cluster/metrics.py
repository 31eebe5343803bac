"""Cluster-level telemetry (the port's copy of
``repro.serve.cluster.metrics``, over the port's ``serve.telemetry``): one
TelemetryController + MetricsSink PER replica (a controller's ``bind`` refuses a second engine — the drift
buckets are shape-derived per engine), aggregated here with per-replica
tags.

The aggregation is deliberately thin: per-replica sinks stay the source
of truth (ring capacity, lifetime totals, drift events all per-engine),
and :class:`ClusterTelemetry` only merges at read time — ``summary()``
recomputes the cluster-wide request p50/p99 over ALL replicas' request
records (a mean of per-replica percentiles would be wrong), and
``export_jsonl`` re-tags each replica's lines with ``"replica": i`` so
one shipped file carries the whole cluster.

Chaos extensions: ``stream_dir`` turns on each sink's incremental
append-and-flush JSONL stream (``replica_<i>.jsonl``) so a replica that
dies mid-drill leaves its telemetry tail on disk; ``tag_dead`` appends
the fault verdict to that stream and records it for ``summary()``;
``rebind`` retires a dead replica's sink/controller pair and stands up a
fresh one for the warm-rejoined engine (a controller's ``bind`` refuses
a second engine, so rejoin MUST re-bind).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

from repro_torch.serve.telemetry.control import TelemetryController
from repro_torch.serve.telemetry.metrics import MetricsSink, quantile


class ClusterTelemetry:
    """N controllers, one per replica; merged read-side views.

    ``controller(i)`` hands out the i-th controller — exactly what
    ``ServingCluster.build`` passes to the i-th replica's constructor.
    Controller knobs (``latency_model``, ``drift``, ``recalibrate``)
    apply to every replica identically.  ``slo`` (an
    :class:`~repro_torch.serve.telemetry.slo.SLO`) gives every controller its
    OWN token bucket — buckets hold mutable admission state and cannot
    be shared across engines any more than controllers can.
    """

    def __init__(self, n_replicas: int, *, capacity: int = 4096,
                 latency_model=None, drift=False, recalibrate: bool = False,
                 slo=None, stream_dir: "Path | str | None" = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self._ctor = dict(capacity=capacity, latency_model=latency_model,
                          drift=drift, recalibrate=recalibrate, slo=slo)
        self.stream_dir = Path(stream_dir) if stream_dir is not None else None
        self.sinks: List[MetricsSink] = []
        self.controllers: List[TelemetryController] = []
        for i in range(n_replicas):
            sink, ctrl = self._make_pair(i)
            self.sinks.append(sink)
            self.controllers.append(ctrl)
        # fault-tagged (replica, t_s, kind) verdicts + retired sinks
        # (kept as (replica, sink) — faults and rebinds are not 1:1, a
        # crash-looping replica tags several deaths per rebind)
        self.faults: List[Dict[str, Any]] = []
        self.retired: List = []           # [(replica, MetricsSink), ...]
        self._generation = [0] * n_replicas

    def _make_pair(self, i: int):
        stream = (None if self.stream_dir is None
                  else self.stream_dir / f"replica_{i}.jsonl")
        sink = MetricsSink(capacity=self._ctor["capacity"],
                           stream_path=stream)
        ctrl = TelemetryController(
            sink, drift=self._ctor["drift"],
            latency_model=self._ctor["latency_model"],
            recalibrate=self._ctor["recalibrate"],
            slo=self._ctor["slo"])
        return sink, ctrl

    @property
    def n_replicas(self) -> int:
        return len(self.sinks)

    def controller(self, i: int) -> TelemetryController:
        return self.controllers[i]

    # -- fault bookkeeping ----------------------------------------------------
    def tag_dead(self, i: int, t_s: float, kind: str) -> None:
        """Mark replica ``i``'s record stream with its fault verdict —
        the line lands on the incremental stream immediately (the whole
        point: the verdict must survive even if nothing ever exports),
        and the verdict is carried in ``summary()``/``export_jsonl``."""
        tag = {"replica": i, "t_s": float(t_s), "kind": str(kind)}
        self.faults.append(tag)
        self.sinks[i].stream_note({"record": "fault", **tag})

    def rebind(self, i: int) -> TelemetryController:
        """Retire replica ``i``'s sink/controller and stand up a fresh
        pair for a warm-rejoined engine.  The retired sink keeps the dead
        incarnation's records (and stays in ``export_jsonl``); the fresh
        sink streams to a generation-suffixed file so the post-mortem
        and the rejoin never interleave in one stream."""
        old = self.sinks[i]
        old.close_stream()
        self.retired.append((i, old))
        self._generation[i] += 1
        sink, ctrl = self._make_pair(i)
        if self.stream_dir is not None:
            sink.open_stream(self.stream_dir
                             / f"replica_{i}.g{self._generation[i]}.jsonl")
        self.sinks[i] = sink
        self.controllers[i] = ctrl
        return ctrl

    # -- merged views ---------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """Cluster block plus the per-replica summaries verbatim."""
        per_replica = [s.summary() for s in self.sinks]
        all_sinks = self.sinks + [s for _, s in self.retired]
        lat = [r.latency_s for s in all_sinks for r in s.requests()]
        out = {
            "n_replicas": self.n_replicas,
            "requests": sum(s.total_requests for s in all_sinks),
            "steps": sum(s.total_steps for s in all_sinks),
            "latency_p50_s": quantile(lat, 0.50),
            "latency_p99_s": quantile(lat, 0.99),
            "per_replica": per_replica,
        }
        if self.faults:
            out["faults"] = list(self.faults)
        return out

    def request_latencies(self) -> List[float]:
        return [r.latency_s
                for s in self.sinks + [s for _, s in self.retired]
                for r in s.requests()]

    def export_jsonl(self, path: "Path | str") -> Path:
        """Every replica's ring, one tagged JSON object per line, each
        carrying its ``"replica"`` index next to the ``"record"`` tag.
        Retired (pre-fault) sinks export first under their replica index,
        then the live rings, then the fault tags — the shipped file reads
        in event order per replica."""
        out = Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        live = list(enumerate(self.sinks))
        with out.open("w") as fh:
            for i, sink in self.retired + live:
                tmp = out.with_suffix(f".r{i}.tmp")
                sink.export_jsonl(tmp)
                for line in tmp.read_text().splitlines():
                    rec = json.loads(line)
                    fh.write(json.dumps({"replica": i, **rec}) + "\n")
                tmp.unlink()
            for tag in self.faults:
                fh.write(json.dumps({"record": "fault", **tag}) + "\n")
        return out
