"""Calibration loading/normalization for the unified cost model.

Three on-disk formats feed the model, all produced by this repo:

  * the paper transcription  (``ampere_a100.json``: SASS ``instructions`` +
    ``dependent_vs_independent`` + ``tensor_core`` WMMA rows, Tables I-V);
  * a design-estimate table (``vpu`` CPIs + ``mxu`` peaks + ``memory``
    latencies/bandwidth), the reference package's target format;
  * campaign-derived tables (``core.campaign.report.calibration_from_results``:
    measured ``ops``/``memory``/``mxu`` sections straight from result
    files), such as the card's ``hopper_h100.json``.

``Calibration.from_dict`` normalizes any of them into ONE canonical shape —
per-op instruction entries with the paper's dependent/independent split, a
memory-hierarchy level list with per-level latency plus streaming bandwidth,
and an MXU throughput surface over (dtype, tile shape) — which the three
layers in ``instruction.py`` / ``memory.py`` / ``mxu.py`` consume.
``to_dict``/``from_dict`` round-trip losslessly (the canonical schema), so a
calibration can be persisted and reloaded without drift.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

CALIB_DIR = Path(__file__).resolve().parents[1] / "calibration"

CANONICAL_KIND = "costmodel_calibration"
CANONICAL_VERSION = 1

# dtype spellings seen across the three formats -> canonical short names
_DTYPE_CANON = {
    "float32": "f32", "f32": "f32", "bfloat16": "bf16", "bf16": "bf16",
    "float16": "f16", "f16": "f16", "f16x2": "f16", "float64": "f64",
    "f64": "f64", "tf32": "tf32", "int32": "s32", "s32": "s32",
    "int8": "s8", "s8": "s8", "u32": "s32", "b32": "s32", "int": "s32",
}


def canon_dtype(dt: str) -> str:
    return _DTYPE_CANON.get(dt, dt)


# SASS opcode (the paper's Table II rows) -> (generic op, canonical dtype).
# Memory instructions (LDG/LDS) route to the memory layer instead.
_SASS_TO_OP = {
    "FADD.f32": ("add", "f32"), "FMUL.f32": ("mul", "f32"),
    "FFMA.f32": ("fma", "f32"), "FADD.f16x2": ("add", "f16"),
    "HFMA2.f16x2": ("fma", "f16"), "DADD.f64": ("add", "f64"),
    "DMUL.f64": ("mul", "f64"), "DFMA.f64": ("fma", "f64"),
    "IADD3.s32": ("add", "s32"), "IMAD.s32": ("fma", "s32"),
    "LOP3.b32": ("and", "s32"), "SHF.b32": ("shift", "s32"),
    "POPC.b32": ("popc", "s32"), "FLO.u32": ("clz", "s32"),
    "ISETP.s32": ("compare", "s32"), "SEL.b32": ("select", "s32"),
    "MUFU.RCP.f32": ("div", "f32"), "MUFU.RSQ.f32": ("rsqrt", "f32"),
    "MUFU.SQRT.f32": ("sqrt", "f32"), "MUFU.EX2.f32": ("exp", "f32"),
    "MUFU.LG2.f32": ("log", "f32"), "MUFU.SIN.f32": ("sin", "f32"),
    "MUFU.TANH.f32": ("tanh", "f32"),
}

# memory-access SASS rows -> (level name, assumed capacity).  The paper
# reports latencies, not sizes; capacities are the A100 datasheet values.
_SASS_MEMORY = {
    "LDS": ("smem", 164 * 2**10),
    "LDG.E.ca": ("l1", 192 * 2**10),
    "LDG.E.cg": ("l2", 40 * 2**20),
}


@dataclass
class InstructionEntry:
    """One per-op latency row: the paper's Table II dependent/independent
    split, in cycles at the calibration's clock."""
    op: str
    dtype: str
    dependent_cycles: float
    independent_cycles: float
    pipeline: str = ""
    source_key: str = ""      # the raw-table key this row came from

    @property
    def key(self) -> str:
        return f"{self.op}.{self.dtype}"


@dataclass
class MemoryLevel:
    """One rung of the hierarchy ladder (Table IV row)."""
    name: str
    capacity_bytes: float
    latency_ns: float
    source_key: str = ""


@dataclass
class MXUPoint:
    """One measured (dtype, tile shape) throughput point (Table III row)."""
    dtype: str
    shape: Optional[Tuple[int, int, int]]
    flops_per_s: float
    cycles: Optional[float] = None
    dependent: bool = False
    source_key: str = ""


@dataclass
class Calibration:
    """The normalized measured-table bundle every cost-model layer reads.

    Pure data with a lossless ``to_dict``/``from_dict`` round-trip — the
    property downstream consumers build on: tables ship as JSON, campaign
    results convert in (``report.calibration_from_results``), and a
    recalibration is a copy-scale-rebuild that never mutates the source
    instance.
    """
    name: str
    hardware: str
    clock_hz: float
    instructions: Dict[str, InstructionEntry] = field(default_factory=dict)
    memory_levels: List[MemoryLevel] = field(default_factory=list)
    bandwidth_bps: Optional[float] = None      # streaming bytes/s
    mxu_points: List[MXUPoint] = field(default_factory=list)
    mxu_peaks: Dict[str, float] = field(default_factory=dict)  # dtype->FLOP/s
    source: str = ""
    raw: Dict[str, Any] = field(default_factory=dict, repr=False)

    # ----- canonical round-trip ----------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": CANONICAL_KIND,
            "version": CANONICAL_VERSION,
            "name": self.name,
            "hardware": self.hardware,
            "clock_hz": self.clock_hz,
            "source": self.source,
            "instructions": {
                k: dataclasses.asdict(e)
                for k, e in sorted(self.instructions.items())},
            "memory_levels": [dataclasses.asdict(l)
                              for l in self.memory_levels],
            "bandwidth_bps": self.bandwidth_bps,
            "mxu_points": [
                {**dataclasses.asdict(p),
                 "shape": list(p.shape) if p.shape else None}
                for p in self.mxu_points],
            "mxu_peaks": dict(sorted(self.mxu_peaks.items())),
        }

    @classmethod
    def from_dict(cls, doc: Dict[str, Any], name: str = "") -> "Calibration":
        """Normalize any supported table format (see module doc)."""
        if doc.get("kind") == CANONICAL_KIND:
            return cls._from_canonical(doc)
        if "instructions" in doc and "tensor_core" in doc:
            return cls._from_paper_table(doc, name)
        if "ops" in doc:
            return cls._from_campaign_table(doc, name)
        if "vpu" in doc:
            return cls._from_target_table(doc, name)
        raise ValueError(
            "unrecognized calibration format: expected one of "
            f"{CANONICAL_KIND!r}, a paper table ('instructions'+"
            "'tensor_core'), a campaign table ('ops'), or a target table "
            "('vpu')")

    # ----- format-specific normalizers ---------------------------------------

    @classmethod
    def _from_canonical(cls, doc) -> "Calibration":
        return cls(
            name=doc.get("name", ""),
            hardware=doc.get("hardware", ""),
            clock_hz=float(doc.get("clock_hz") or 1e9),
            instructions={k: InstructionEntry(**e)
                          for k, e in doc.get("instructions", {}).items()},
            memory_levels=[MemoryLevel(**l)
                           for l in doc.get("memory_levels", [])],
            bandwidth_bps=doc.get("bandwidth_bps"),
            mxu_points=[MXUPoint(**{**p, "shape": tuple(p["shape"])
                                    if p.get("shape") else None})
                        for p in doc.get("mxu_points", [])],
            mxu_peaks={k: float(v)
                       for k, v in doc.get("mxu_peaks", {}).items()},
            source=doc.get("source", ""),
            raw=doc,
        )

    @classmethod
    def _from_paper_table(cls, doc, name) -> "Calibration":
        """ampere_a100.json: the transcribed Tables I-V."""
        clock = float(doc.get("clock_mhz", 1000)) * 1e6
        cal = cls(name=name or doc.get("hardware", "paper"),
                  hardware=doc.get("hardware", ""), clock_hz=clock,
                  source=doc.get("source", ""), raw=doc)
        dep_ind = doc.get("dependent_vs_independent", {})
        for key, row in doc.get("instructions", {}).items():
            if key in _SASS_MEMORY:
                lname, cap = _SASS_MEMORY[key]
                cal.memory_levels.append(MemoryLevel(
                    name=lname, capacity_bytes=cap,
                    latency_ns=row["latency_cycles"] / clock * 1e9,
                    source_key=key))
                continue
            if key not in _SASS_TO_OP:
                continue
            op, dt = _SASS_TO_OP[key]
            lat = float(row["latency_cycles"])
            di = dep_ind.get(key, {})
            cal.instructions[f"{op}.{dt}"] = InstructionEntry(
                op=op, dtype=dt,
                dependent_cycles=float(di.get("dependent", lat)),
                independent_cycles=float(di.get("independent", lat)),
                pipeline=row.get("pipeline", ""), source_key=key)
        for key, row in doc.get("tensor_core", {}).items():
            # "wmma.m16n16k16.f16" -> shape + dtype; flops = 2*m*n*k
            parts = key.split(".")
            shape = _parse_mnk(parts[1]) if len(parts) > 1 else None
            dt = canon_dtype(parts[-1])
            cycles = float(row["cycles"])
            fl = 2.0 * shape[0] * shape[1] * shape[2] if shape else 0.0
            cal.mxu_points.append(MXUPoint(
                dtype=dt, shape=shape, cycles=cycles,
                flops_per_s=fl / (cycles / clock) if cycles else 0.0,
                dependent=True, source_key=key))
        cal.memory_levels.sort(key=lambda l: l.capacity_bytes)
        return cal

    @classmethod
    def _from_target_table(cls, doc, name) -> "Calibration":
        """A design-estimate table: CPIs + MXU peaks + memory constants."""
        clock = float(doc.get("clock_mhz", 1000)) * 1e6
        cal = cls(name=name or doc.get("hardware", "target"),
                  hardware=doc.get("hardware", ""), clock_hz=clock,
                  source=doc.get("source", ""), raw=doc)
        for key, row in doc.get("vpu", {}).items():
            op, dt = key.rsplit(".", 1)
            dt = canon_dtype(dt)
            cpi = float(row["cpi"])
            cal.instructions[f"{op}.{dt}"] = InstructionEntry(
                op=op, dtype=dt, dependent_cycles=cpi,
                independent_cycles=cpi, source_key=key)
        for key, row in doc.get("mxu", {}).items():
            dt = canon_dtype(key.split(".")[0])
            peak = float(row["peak_tflops"]) * 1e12
            cal.mxu_peaks[dt] = peak
            tile = row.get("tile")
            shape = (tile[0], tile[1], tile[1]) if tile else None
            cal.mxu_points.append(MXUPoint(
                dtype=dt, shape=shape, flops_per_s=peak, source_key=key))
        mem = doc.get("memory", {})
        if "vmem_mib" in mem:
            cal.memory_levels.append(MemoryLevel(
                "vmem", mem["vmem_mib"] * 2**20,
                mem.get("vmem_latency_ns", 30.0), source_key="vmem"))
        if "hbm_gib" in mem:
            cal.memory_levels.append(MemoryLevel(
                "hbm", mem["hbm_gib"] * 2**30,
                mem.get("hbm_latency_ns", 500.0), source_key="hbm"))
        if "hbm_bandwidth_gbs" in mem:
            cal.bandwidth_bps = mem["hbm_bandwidth_gbs"] * 1e9
        return cal

    @classmethod
    def _from_campaign_table(cls, doc, name) -> "Calibration":
        """report.calibration_from_results output: measured campaign table."""
        clock = (float(doc["clock_mhz"]) * 1e6 if "clock_mhz" in doc
                 else float(doc.get("clock_hz") or 1e9))
        cal = cls(name=name or doc.get("hardware", "measured"),
                  hardware=doc.get("hardware", ""), clock_hz=clock,
                  source=doc.get("source", ""), raw=doc)
        # ops: "add.float32.dep" / "add.float32.ind" pairs -> one entry
        pending: Dict[str, Dict[str, float]] = {}
        for key, row in doc.get("ops", {}).items():
            base, tag = key.rsplit(".", 1)
            cycles = row["per_op_ns"] * 1e-9 * clock
            pending.setdefault(base, {})[tag] = cycles
        for base, tags in pending.items():
            op, dt = base.rsplit(".", 1)
            dt = canon_dtype(dt)
            dep = tags.get("dep", tags.get("ind", 0.0))
            ind = tags.get("ind", dep)
            cal.instructions[f"{op}.{dt}"] = InstructionEntry(
                op=op, dtype=dt, dependent_cycles=dep,
                independent_cycles=ind, source_key=base)
        for key, row in doc.get("memory", {}).items():
            ws = float(key)
            cal.memory_levels.append(MemoryLevel(
                name=f"ws_{int(ws) // 1024}KiB", capacity_bytes=ws,
                latency_ns=row["per_hop_ns"], source_key=key))
        cal.memory_levels.sort(key=lambda l: l.capacity_bytes)
        streams = [row["gbps"] * 1e9
                   for row in doc.get("memory_streaming", {}).values()]
        roof = doc.get("roofline", {})
        if "hbm_stream_gbs" in roof:
            streams.append(roof["hbm_stream_gbs"]["value"] * 1e9)
        if streams:
            cal.bandwidth_bps = max(streams)
        for key, row in doc.get("mxu", {}).items():
            # "float32.m128n128k128.dep"
            parts = key.split(".")
            dt = canon_dtype(parts[0])
            shape = _parse_mnk(parts[1]) if len(parts) > 2 else None
            dep = parts[-1] == "dep"
            cal.mxu_points.append(MXUPoint(
                dtype=dt, shape=shape, flops_per_s=row["tflops"] * 1e12,
                dependent=dep, source_key=key))
        if "mxu_peak_tflops" in roof:
            best = roof["mxu_peak_tflops"]["value"] * 1e12
            # the roofline probe measures the f32 path on this harness
            cal.mxu_peaks.setdefault("f32", best)
        for p in cal.mxu_points:
            if not p.dependent and p.flops_per_s > 0:   # skip failed probes
                cur = cal.mxu_peaks.get(p.dtype, 0.0)
                cal.mxu_peaks[p.dtype] = max(cur, p.flops_per_s)
        return cal


def _parse_mnk(token: str) -> Optional[Tuple[int, int, int]]:
    """'m16n16k16' -> (16, 16, 16)."""
    import re
    m = re.fullmatch(r"m(\d+)n(\d+)k(\d+)", token)
    return (int(m.group(1)), int(m.group(2)), int(m.group(3))) if m else None


def load_calibration(name_or_path: "str | Path") -> Calibration:
    """Resolve a calibration by shipped name (``ampere_a100``,
    ``hopper_h100``), JSON file path, or campaign results directory (through
    ``core.microbench.tables.table_from_results``)."""
    p = Path(name_or_path)
    if p.is_dir():
        from repro_torch.core.microbench.tables import table_from_results
        return Calibration.from_dict(table_from_results(p), name=str(p))
    if not p.suffix:
        shipped = CALIB_DIR / f"{p.name}.json"
        if shipped.exists():
            p = shipped
    if not p.exists():
        raise FileNotFoundError(
            f"no calibration {str(name_or_path)!r}: not a shipped name "
            f"({', '.join(sorted(q.stem for q in CALIB_DIR.glob('*.json')))}),"
            " file path, or campaign results directory")
    return Calibration.from_dict(json.loads(p.read_text()), name=p.stem)
