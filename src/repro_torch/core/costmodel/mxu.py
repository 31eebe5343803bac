"""MXU layer: a shape/dtype throughput surface for matrix-unit compute.

Replaces the single ``peak_flops_bf16`` scalar of the old roofline with the
paper's Table III view: measured throughput per (dtype, tile shape) point —
WMMA fragments on the paper's A100, the tensor-core probes of the
``mxu_shapes`` campaign on the H100 — with hardware-spec peaks as the
envelope only when the calibration measured nothing at all.

A dtype the calibration never measured resolves through RELATIVE rates
against the layer's own reference dtype — never by jumping to a different
scale (chip peak vs per-instruction rate) — so the ordering invariant the
paper establishes (f32 no faster than bf16/f16 on the matrix unit) holds
for any calibration mix.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.costmodel.calibration import (Calibration, MXUPoint,
                                                    canon_dtype)
from repro_torch.core.perfmodel.hardware import HardwareSpec

# matrix-unit rate of each dtype relative to bf16 (Ampere Table III /
# datasheet ratios; used only when a dtype has no measured point or peak)
_RELATIVE_RATE = {"bf16": 1.0, "f16": 1.0, "tf32": 0.5, "f32": 0.5,
                  "f64": 1.0 / 16.0, "s8": 2.0}


class MXULayer:
    def __init__(self, cal: Calibration, hw: Optional[HardwareSpec] = None):
        self.points: Dict[Tuple[str, Optional[Tuple[int, int, int]], bool],
                          MXUPoint] = {}
        for p in cal.mxu_points:
            self.points[(p.dtype, p.shape, p.dependent)] = p
        self.peaks: Dict[str, float] = dict(cal.mxu_peaks)
        self.spec_peaks: Dict[str, float] = {}
        if hw is not None:
            self.spec_peaks["bf16"] = hw.peak_flops_bf16
            if hw.peak_flops_f32:
                self.spec_peaks["f32"] = min(hw.peak_flops_f32,
                                             hw.peak_flops_bf16)
        self.clock_hz = cal.clock_hz or 1e9

    def _best_point(self, dtype: Optional[str] = None,
                    dependent: Optional[bool] = None) -> float:
        best = 0.0
        for (pdt, _, pdep), p in self.points.items():
            if dtype is not None and pdt != dtype:
                continue
            if dependent is not None and pdep != dependent:
                continue
            best = max(best, p.flops_per_s)
        return best

    def _ref(self) -> Tuple[str, float]:
        """Reference (dtype, FLOP/s) for relative-rate resolution — always
        from the calibration's own scale when it measured anything."""
        for dt in ("bf16", "f16"):
            if self.peaks.get(dt, 0.0) > 0:
                return dt, self.peaks[dt]
            best = self._best_point(dt)
            if best > 0:
                return dt, best
        if self.peaks and max(self.peaks.values()) > 0:
            dt = max(self.peaks, key=self.peaks.get)
            return dt, self.peaks[dt]
        any_best = 0.0
        any_dt = "bf16"
        for (pdt, _, _), p in self.points.items():
            if p.flops_per_s > any_best:
                any_best, any_dt = p.flops_per_s, pdt
        if any_best > 0:
            return any_dt, any_best
        return "bf16", self.spec_peaks.get("bf16", 1e12)

    def throughput(self, dtype: str = "bf16",
                   shape: Optional[Tuple[int, int, int]] = None,
                   dependent: bool = False) -> float:
        """Effective FLOP/s for a dtype (and optionally an exact tile shape).

        Resolution: exact measured point -> calibration peak -> best
        measured point for the dtype -> relative rate vs the calibration's
        reference dtype.  Guaranteed > 0.
        """
        dt = canon_dtype(dtype)
        if shape is not None:
            p = self.points.get((dt, tuple(shape), dependent)) \
                or self.points.get((dt, tuple(shape), not dependent))
            if p is not None and p.flops_per_s > 0:
                return p.flops_per_s
        if self.peaks.get(dt, 0.0) > 0:   # degenerate 0-rate rows fall past
            return self.peaks[dt]
        best = self._best_point(dt, dependent)
        if best <= 0:
            best = self._best_point(dt)
        if best > 0:
            return best
        ref_dt, ref = self._ref()
        rel = _RELATIVE_RATE.get(dt, 1.0) / _RELATIVE_RATE.get(ref_dt, 1.0)
        return max(ref * rel, 1.0)

    def time_for_flops(self, flops: float, dtype: str = "bf16",
                       shape: Optional[Tuple[int, int, int]] = None) -> float:
        return float(flops) / self.throughput(dtype, shape)

    def tile_latency_s(self, dtype: str,
                       shape: Tuple[int, int, int]) -> Optional[float]:
        """Latency of ONE dependent tile op, if measured (Table III column)."""
        p = self.points.get((canon_dtype(dtype), tuple(shape), True))
        if p is None:
            return None
        if p.cycles is not None:
            return p.cycles / self.clock_hz
        fl = 2.0 * shape[0] * shape[1] * shape[2]
        return fl / p.flops_per_s if p.flops_per_s else None
