"""Memory layer: hierarchy access latencies + streaming bandwidth.

Replaces the flat ``hbm_bandwidth``-only view of the old perf model with
the paper's Table IV shape: a ladder of memory levels (smem/L1/L2 on the
paper's A100; measured working-set rungs from the pointer-chase
campaign on the H100), each with a per-access latency, plus the
contrasting streaming bandwidth for bulk traffic.

``transfer_seconds`` prices bulk byte movement (the roofline memory term);
``access_latency_ns`` answers the latency question the chase campaign
measures: how long one dependent access takes at a given working-set size.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.costmodel.calibration import Calibration, MemoryLevel
from repro_torch.core.perfmodel.hardware import HardwareSpec


class MemoryLayer:
    def __init__(self, cal: Calibration, hw: Optional[HardwareSpec] = None):
        self.levels: List[MemoryLevel] = sorted(
            cal.memory_levels, key=lambda l: l.capacity_bytes)
        self.clock_hz = cal.clock_hz or 1e9
        # measured streaming bandwidth, else the hardware-spec constant
        self.bandwidth_bps = float(
            cal.bandwidth_bps or (hw.hbm_bandwidth if hw else 0.0) or 819e9)

    def level_for(self, working_set_bytes: float) -> Optional[MemoryLevel]:
        """Smallest level that holds the working set (else the last one —
        past the last rung everything is backing-store resident)."""
        if not self.levels:
            return None
        for lvl in self.levels:
            if working_set_bytes <= lvl.capacity_bytes:
                return lvl
        return self.levels[-1]

    def access_latency_ns(self, working_set_bytes: float) -> float:
        lvl = self.level_for(working_set_bytes)
        return lvl.latency_ns if lvl else 0.0

    def access_latency_cycles(self, working_set_bytes: float) -> float:
        return self.access_latency_ns(working_set_bytes) * 1e-9 \
            * self.clock_hz

    def transfer_seconds(self, nbytes: float) -> float:
        """Bulk-traffic time at streaming bandwidth (roofline memory term)."""
        return float(nbytes) / self.bandwidth_bps
