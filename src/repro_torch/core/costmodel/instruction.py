"""Instruction layer: price an op histogram with per-op CPI tables.

The histogram is keyed by HLO op kinds, as the reference's censuses and
the analytic census (``analytic``) write it.  This is the paper's Tables
I/II applied as a simulator input: every top-level op of the step costs
at least an issue slot, and ops whose table row is known cost their
measured CPI (dependent-chain cycles by default — the conservative
latency number; pass ``dependent=False`` for the throughput view of wide
independent streams).

HLO kinds with NO genuine arithmetic counterpart in the table (layout ops,
data movement, RNG, ...) are NOT silently priced as ``add`` — they are
tracked as *defaulted* and surfaced on the returned breakdown so census
gaps stay visible.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.costmodel.calibration import (Calibration,
                                                    InstructionEntry)

# HLO op kind -> table op: only kinds with a real arithmetic counterpart.
# Everything else is defaulted (priced at the issue-slot floor) and REPORTED.
HLO_TO_TABLE: Dict[str, str] = {
    "add": "add", "subtract": "sub", "multiply": "mul", "divide": "div",
    "maximum": "max", "minimum": "min", "abs": "abs", "negate": "sub",
    "and": "and", "or": "and", "xor": "xor", "not": "and",
    "exponential": "exp", "exponential-minus-one": "exp",
    "log": "log", "log-plus-one": "log", "tanh": "tanh",
    "rsqrt": "rsqrt", "sqrt": "sqrt", "cbrt": "rsqrt",
    "sine": "sin", "cosine": "sin", "logistic": "sigmoid",
    "power": "exp", "remainder": "rem", "atan2": "tanh", "erf": "tanh",
    "select": "select", "clamp": "select", "sign": "select",
    "compare": "compare", "is-finite": "compare",
    "shift-left": "shift", "shift-right-logical": "shift",
    "shift-right-arithmetic": "shift", "popcnt": "popc", "clz": "clz",
    "fusion": "fma", "map": "fma",
}

# table-op fallback chain when a calibration lacks a row (e.g. a table
# with no 'compare'/'shift'; the nearest same-pipeline op prices it instead)
_OP_FALLBACK = {"compare": "select", "shift": "and", "sub": "add",
                "rem": "div"}

# kinds priced by the MXU layer's compute term: they still take an issue
# slot here but are NOT census gaps (no CPI row expected)
_MXU_PRICED = {"dot", "convolution"}


@dataclass
class IssueCost:
    """Breakdown of one histogram pricing pass."""
    seconds: float
    cycles: float
    mapped_cycles: float
    defaulted_cycles: float
    # HLO kind -> weighted count that fell through to the issue-slot floor
    defaulted_ops: Dict[str, float] = field(default_factory=dict)
    mapped_ops: Dict[str, float] = field(default_factory=dict)

    @property
    def defaulted_count(self) -> float:
        return float(sum(self.defaulted_ops.values()))

    @property
    def mapped_count(self) -> float:
        return float(sum(self.mapped_ops.values()))


class InstructionLayer:
    """Per-op CPI lookups over a normalized calibration."""

    def __init__(self, cal: Calibration, issue_cycles: float = 12.0):
        self.entries: Dict[str, InstructionEntry] = dict(cal.instructions)
        self.clock_hz = cal.clock_hz or 1e9
        self.issue_cycles = issue_cycles
        self._by_op: Dict[str, InstructionEntry] = {}
        for e in cal.instructions.values():
            # per-op fallback row, f32 preferred
            if e.op not in self._by_op or e.dtype == "f32":
                self._by_op[e.op] = e

    def entry(self, op: str, dtype: str = "f32"
              ) -> Optional[InstructionEntry]:
        e = self.entries.get(f"{op}.{dtype}") or self._by_op.get(op)
        if e is None and op in _OP_FALLBACK:
            return self.entry(_OP_FALLBACK[op], dtype)
        return e

    def cycles(self, op: str, dtype: str = "f32",
               dependent: bool = True) -> Optional[float]:
        e = self.entry(op, dtype)
        if e is None:
            return None
        return e.dependent_cycles if dependent else e.independent_cycles

    def seconds(self, op: str, dtype: str = "f32",
                dependent: bool = True) -> Optional[float]:
        c = self.cycles(op, dtype, dependent)
        return None if c is None else c / self.clock_hz

    def price_histogram(self, op_histogram: Dict[str, float],
                        dtype: str = "f32",
                        dependent: bool = True) -> IssueCost:
        """Total issue cost of an op-kind histogram (census
        ``op_histogram``).  Mapped kinds cost ``max(issue floor, CPI)``;
        unmapped kinds cost the issue floor and are recorded as defaulted."""
        mapped_cyc = defaulted_cyc = 0.0
        defaulted: Dict[str, float] = {}
        mapped: Dict[str, float] = {}
        for kind, count in op_histogram.items():
            table_op = HLO_TO_TABLE.get(kind)
            cpi = self.cycles(table_op, dtype, dependent) \
                if table_op else None
            if cpi is None and kind in _MXU_PRICED:
                cpi = self.issue_cycles   # compute term owns the real cost
            if cpi is None:
                defaulted[kind] = defaulted.get(kind, 0.0) + count
                defaulted_cyc += count * self.issue_cycles
            else:
                mapped[kind] = mapped.get(kind, 0.0) + count
                mapped_cyc += count * max(self.issue_cycles, cpi)
        total = mapped_cyc + defaulted_cyc
        return IssueCost(seconds=total / self.clock_hz, cycles=total,
                         mapped_cycles=mapped_cyc,
                         defaulted_cycles=defaulted_cyc,
                         defaulted_ops=defaulted, mapped_ops=mapped)
