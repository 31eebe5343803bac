"""Apply a drift verdict: rescale the calibration, rebuild the model,
invalidate stale tuned configs (the port's copy of
``repro.serve.telemetry.recalibrate``, over the port's ``Calibration``,
``CostModel`` and tuning cache).

The calibration round-trip (``Calibration.to_dict``/``from_dict`` is
lossless) makes online recalibration a *pure-data* update: copy the
table, scale the rows the drift implicates, rebuild a ``CostModel`` on
the copy.  Nothing mutates the shipped calibration files and the old
model object stays valid for anyone still holding it.

Which rows get scaled follows the bottleneck the engine's own
predictions attribute the drifted step to (``Prediction.bottleneck``):

* ``memory``-bound drift → the streaming ``bandwidth_bps`` (and per-level
  latencies) — measured/predicted ratio ``r`` means real bandwidth is
  ``1/r`` of the table's;
* ``compute``-bound drift → the MXU surface (``mxu_peaks`` and every
  ``mxu_points`` throughput) scaled by ``1/r``;
* unknown/mixed → uniform: all of the above **plus** the instruction CPI
  table scaled by ``r`` — conservative, keeps every layer consistent.

Because the :class:`~repro_torch.core.autotune.cache.TuningCache` key
embeds ``calibration_id`` (its fifth component: a cache tuned against one
calibration never leaks configs onto another), configs ranked under the drifted
calibration are unreachable-but-stale after a swap;
:func:`invalidate_tuning_entries` drops them so the cache file doesn't
accumulate dead weight and ``autotune show`` reflects reality.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.costmodel.calibration import Calibration
from repro_torch.core.costmodel.model import CostModel


def rescale_calibration(cal: Calibration, factor: float, *,
                        bottleneck: str = "",
                        name_suffix: str = "+recal") -> Calibration:
    """Return a NEW calibration whose predictions scale by ``factor``
    (= measured/predicted from the drift window) for the implicated
    ``bottleneck`` term.  The input is never mutated."""
    if factor <= 0:
        raise ValueError("rescale factor must be positive")
    new = Calibration.from_dict(cal.to_dict())
    new.name = (cal.name or "calibration") + name_suffix
    inv = 1.0 / factor

    def scale_memory():
        if new.bandwidth_bps:
            new.bandwidth_bps *= inv
        for lvl in new.memory_levels:
            lvl.latency_ns *= factor

    def scale_compute():
        for dt in new.mxu_peaks:
            new.mxu_peaks[dt] *= inv
        for p in new.mxu_points:
            p.flops_per_s *= inv
            if p.cycles is not None:
                p.cycles *= factor

    if bottleneck == "memory":
        scale_memory()
    elif bottleneck == "compute":
        scale_compute()
    else:
        # unknown attribution: keep every layer mutually consistent
        scale_memory()
        scale_compute()
        for e in new.instructions.values():
            e.dependent_cycles *= factor
            e.independent_cycles *= factor
    return new


def recalibrated_cost_model(model: CostModel, factor: float, *,
                            bottleneck: str = "") -> CostModel:
    """A fresh :class:`CostModel` over the rescaled calibration, keeping
    the original's hardware spec and issue-cycle setting."""
    cal = rescale_calibration(model.cal, factor, bottleneck=bottleneck)
    return CostModel(cal, hw=model.hw,
                     issue_cycles=model.instructions.issue_cycles)


def invalidate_tuning_entries(cache, *,
                              calibration_id: Optional[str] = None) -> int:
    """Drop tuning-cache entries ranked under a now-stale calibration.

    ``calibration_id=None`` drops everything (the conservative default
    when the caller cannot name the calibration the entries were tuned
    under).  Returns the number of entries removed; flushes if any were.
    """
    from repro_torch.core.autotune.cache import split_key
    stale = [key for key in cache.entries
             if calibration_id is None
             or split_key(key)[4] == calibration_id]
    for key in stale:
        del cache.entries[key]
    if stale:
        cache.flush()
    return len(stale)
