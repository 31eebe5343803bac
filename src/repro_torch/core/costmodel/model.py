"""The composed cost model: instruction + memory + MXU layers behind one
``CostModel.predict(census, spec)`` API.

Given a census of one step (``analytic.analytic_census``, or a JSON record
with the same keys) and a normalized calibration, the predicted
per-device step time is

    t = max(compute, memory, collective) + issue_overhead

with compute priced by the MXU throughput surface, memory by the hierarchy
layer's streaming bandwidth, collectives by the hardware-spec ICI links and
the issue term by the per-op CPI table — including an explicit record of
census ops the table could NOT price (``Prediction.defaulted_ops``), so
model gaps are visible instead of silently costed as ``add``.

The reference's ``predict_compiled`` and ``predict_fn`` census compiled HLO
text; the port lowers nothing to HLO, so it has neither and prices
censuses only.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Union

from repro_torch.core.costmodel.calibration import (Calibration,
                                                    canon_dtype,
                                                    load_calibration)
from repro_torch.core.costmodel.instruction import InstructionLayer, IssueCost
from repro_torch.core.costmodel.memory import MemoryLayer
from repro_torch.core.costmodel.mxu import MXULayer
from repro_torch.core.perfmodel.hardware import (SPECS, H100_SXM,
                                                 HardwareSpec)

# calibration "hardware" strings -> HardwareSpec names: the paper's table
# names its A100; the port's campaign writes its backend, "gpu", and a
# table may name the card as ``torch.cuda.get_device_name`` reports it
_HW_ALIASES = {
    "nvidia-a100-40g": "a100-40g",
    "gpu": H100_SXM.name,
    "cuda": H100_SXM.name,
    "NVIDIA H100 80GB HBM3": H100_SXM.name,
}


@dataclass
class Prediction:
    """One priced step: the three roofline terms, the instruction-issue
    overhead, and the census-coverage record."""
    compute_s: float
    memory_s: float
    collective_s: float
    issue_overhead_s: float
    step_s: float
    bottleneck: str
    dtype: str = "bf16"
    hw: str = ""
    calibration: str = ""
    # census op kinds the instruction table could not price (kind -> count)
    defaulted_ops: Dict[str, float] = field(default_factory=dict)
    mapped_op_count: float = 0.0

    @property
    def defaulted_op_count(self) -> float:
        return float(sum(self.defaulted_ops.values()))

    def summary(self) -> str:
        return (f"step={self.step_s:.3e}s ({self.bottleneck}-bound; "
                f"compute={self.compute_s:.3e} memory={self.memory_s:.3e} "
                f"collective={self.collective_s:.3e} "
                f"issue={self.issue_overhead_s:.3e}) "
                f"defaulted_ops={self.defaulted_op_count:.0f}"
                f"/{self.defaulted_op_count + self.mapped_op_count:.0f}")

    def table_row(self) -> Dict[str, Any]:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "issue_overhead_s": self.issue_overhead_s,
            "step_s": self.step_s, "bottleneck": self.bottleneck,
            "defaulted_op_count": self.defaulted_op_count,
        }


def _resolve_hw(cal: Calibration,
                hw: Optional[HardwareSpec]) -> HardwareSpec:
    """The spec a calibration prices against: ``hw`` when given, else the
    one its ``hardware`` string names; anything else (an H100 device name,
    an unknown string) is the port's card."""
    if hw is not None:
        return hw
    name = _HW_ALIASES.get(cal.hardware, cal.hardware)
    return SPECS.get(name, H100_SXM)


class CostModel:
    """Calibrated three-layer performance model.

    Instruction (CPI table + issue cost), memory (bandwidth + per-level
    latency) and MXU (per-dtype peaks + measured tile points) layers over
    one :class:`Calibration`.  Instances are cheap, immutable-by-
    convention views of their calibration: a serving engine swaps in a
    replacement live (``engine.set_cost_model``) rather than mutating a
    model in place.
    """

    def __init__(self, cal: Calibration,
                 hw: Optional[HardwareSpec] = None,
                 issue_cycles: float = 12.0):
        self.cal = cal
        self.hw = _resolve_hw(cal, hw)
        self.instructions = InstructionLayer(cal, issue_cycles=issue_cycles)
        self.memory = MemoryLayer(cal, self.hw)
        self.mxu = MXULayer(cal, self.hw)

    # ----- constructors ------------------------------------------------------

    @classmethod
    def from_named(cls, name: "str | Path" = "hopper_h100",
                   hw: Optional[HardwareSpec] = None) -> "CostModel":
        """Shipped calibration name, JSON path, or campaign results dir."""
        return cls(load_calibration(name), hw=hw)

    @classmethod
    def from_table(cls, table: Mapping[str, Any],
                   hw: Optional[HardwareSpec] = None,
                   name: str = "") -> "CostModel":
        """Any supported calibration-table dict (see ``Calibration``)."""
        return cls(Calibration.from_dict(dict(table), name=name), hw=hw)

    @classmethod
    def from_hardware(cls, hw: HardwareSpec) -> "CostModel":
        """Spec-only model (no measured tables): the pure roofline view."""
        cal = Calibration(name=hw.name, hardware=hw.name,
                          clock_hz=hw.clock_hz or 1e9,
                          bandwidth_bps=hw.hbm_bandwidth,
                          mxu_peaks={"bf16": hw.peak_flops_bf16,
                                     "f32": min(hw.peak_flops_f32,
                                                hw.peak_flops_bf16)})
        return cls(cal, hw=hw)

    # ----- prediction --------------------------------------------------------

    def predict(self, census: Mapping[str, Any],
                spec: Optional[HardwareSpec] = None, *,
                mem_bytes: Optional[float] = None,
                dtype: str = "bf16",
                dependent: bool = False,
                mxu_shape: Optional[tuple] = None) -> Prediction:
        """Price one per-device step from an instruction census.

        ``census`` is a census-shaped dict (``analytic.analytic_census``,
        or a JSON record with the same keys).  ``mem_bytes`` overrides the
        census HBM-byte estimate with an analytic lower bound when available;
        ``spec`` overrides the hardware the collective term prices against;
        ``mxu_shape`` routes the compute term through a specific measured
        (m,n,k) tile point when the calibration has one (the autotuner's
        per-candidate tile) instead of the dtype peak.
        """
        hw = spec or self.hw
        flops = float(census.get("flops", 0.0))
        compute_s = self.mxu.time_for_flops(flops, dtype=dtype,
                                            shape=mxu_shape)
        nbytes = float(mem_bytes if mem_bytes is not None
                       else census.get("hbm_bytes", 0.0))
        memory_s = self.memory.transfer_seconds(nbytes)
        # grid under-utilization: an analytic census may carry the launch
        # grid's cell count ("grid_cells"); with fewer independent cells
        # than the chip's grid lanes (hw.n_cores) the idle lanes cannot
        # stream, so the effective bandwidth shrinks by the utilization
        # ratio.  Censuses without the key (cells = 0) price unchanged.
        # This is the term that makes split-KV flash-decoding
        # win at long context / small batch: more splits -> more cells ->
        # higher utilization, until the partial-row traffic dominates.
        cells = float(census.get("grid_cells", 0.0))
        lanes = float(getattr(hw, "n_cores", 1) or 1)
        if cells > 0.0 and cells < lanes:
            memory_s *= lanes / cells
        coll_b = float(census.get("collective_bytes_total", 0.0))
        coll_bw = hw.ici_link_bandwidth * max(hw.ici_links, 1)
        collective_s = coll_b / coll_bw if coll_bw else 0.0
        issue: IssueCost = self.instructions.price_histogram(
            census.get("op_histogram", {}) or {}, dtype=canon_dtype(dtype),
            dependent=dependent)
        terms = {"compute": compute_s, "memory": memory_s,
                 "collective": collective_s}
        bottleneck = max(terms, key=terms.get)
        return Prediction(
            compute_s=compute_s, memory_s=memory_s,
            collective_s=collective_s, issue_overhead_s=issue.seconds,
            step_s=max(terms.values()) + issue.seconds,
            bottleneck=bottleneck, dtype=dtype, hw=hw.name,
            calibration=self.cal.name,
            defaulted_ops=dict(issue.defaulted_ops),
            mapped_op_count=issue.mapped_count)


# ---------------------------------------------------------------------------
# validation: round-trip the calibration through the layers (the
# prediction-error fixture) + the paper's own consistency relations
# ---------------------------------------------------------------------------

def prediction_error_rows(model: CostModel) -> List[Dict[str, Any]]:
    """Predict every recorded calibration row back through the layer stack
    and report the relative error — the loader/normalization round-trip the
    acceptance fixture checks (must stay within 10%).

    Rows: {name, predicted, recorded, unit, err_pct}.
    """
    rows: List[Dict[str, Any]] = []
    cal = model.cal

    def add(name, predicted, recorded, unit):
        err = (abs(predicted - recorded) / abs(recorded) * 100.0
               if recorded else (100.0 if predicted else 0.0))
        rows.append({"name": name, "predicted": float(predicted),
                     "recorded": float(recorded), "unit": unit,
                     "err_pct": float(err)})

    for e in cal.instructions.values():
        got = model.instructions.cycles(e.op, e.dtype, dependent=True)
        add(f"instr/{e.source_key or e.key}.dep", got or 0.0,
            e.dependent_cycles, "cycles")
        got = model.instructions.cycles(e.op, e.dtype, dependent=False)
        add(f"instr/{e.source_key or e.key}.ind", got or 0.0,
            e.independent_cycles, "cycles")
    for lvl in cal.memory_levels:
        add(f"memory/{lvl.source_key or lvl.name}",
            model.memory.access_latency_ns(lvl.capacity_bytes),
            lvl.latency_ns, "ns")
    if cal.bandwidth_bps:
        gib = 2**30
        add("memory/stream_1GiB",
            model.memory.transfer_seconds(gib), gib / cal.bandwidth_bps, "s")
    for p in cal.mxu_points:
        if p.flops_per_s <= 0 or p.shape is None:
            continue
        got = model.mxu.throughput(p.dtype, p.shape, dependent=p.dependent)
        add(f"mxu/{p.source_key or p.dtype}", got, p.flops_per_s, "FLOP/s")
    return rows


def prediction_error_summary(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    errs = [r["err_pct"] for r in rows]
    return {"rows": len(rows),
            "max_err_pct": max(errs, default=0.0),
            "mean_err_pct": sum(errs) / len(errs) if errs else 0.0}


def validate_against_paper(table: Mapping[str, Any]) -> Dict[str, bool]:
    """The paper's own consistency relations over the raw A100 table:
    SASS expansion x per-SASS cycles == WMMA cycles; dependent CPI >=
    independent CPI; >=3-chain convergence (run as unit tests)."""
    checks: Dict[str, bool] = {}
    tc = table["tensor_core"]
    for k, v in tc.items():
        n = int(v["sass"].split("*")[0])
        checks[f"tc:{k}"] = (n * v["sass_cycles_each"] == v["cycles"]) or \
            (v["cycles"] <= n * v["sass_cycles_each"] + 8)
    for k, v in table["dependent_vs_independent"].items():
        checks[f"dep>=ind:{k}"] = v["dependent"] >= v["independent"]
    conv = table["cpi_convergence"]
    checks["chain_convergence"] = \
        conv["1"] >= conv["2"] >= conv["3"] == conv["4"]
    return checks


def save_calibration(cal: Calibration,
                     out_path: Union[str, Path]) -> Path:
    """Persist a calibration in the canonical round-trip format, defaulting
    artifacts under ``results/`` (output hygiene: generated JSON is never
    tracked)."""
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(cal.to_dict(), indent=1))
    return out
