"""Campaign results -> the calibration table (the port's copy of
``repro.core.campaign.report``'s ``_cells`` and
``calibration_from_results``).

Every function here consumes only validated result documents
(``repro_torch.core.campaign.results``), no re-measurement, so a table can
be rebuilt from the JSON artifacts alone, on any machine.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional


def _cells(doc: Mapping[str, Any], ok_only: bool = True):
    for key in sorted(doc["cells"]):
        rec = doc["cells"][key]
        if ok_only and rec.get("status", "ok") != "ok":
            continue
        yield key, rec["params"], rec["metrics"]


def calibration_from_results(docs: Mapping[str, Mapping[str, Any]],
                             clock_hz: Optional[float] = None
                             ) -> Dict[str, Any]:
    """Build a calibration table from campaign result documents, keyed by
    experiment name.

    The ``vpu`` section converts measured per-op latency to CPI at
    ``clock_hz`` (default 1 GHz when the clock is unknown; on the card the
    SM clock the probe kernels measured).
    """
    clock = clock_hz or 1e9
    backend = next((d.get("backend") for d in docs.values()
                    if d.get("backend")), "unknown")
    table: Dict[str, Any] = {
        "schema_version": 1,
        "hardware": backend,
        "source": "repro_torch.core.campaign results "
                  f"({', '.join(sorted(docs))}) at "
                  f"{time.strftime('%F %T')}",
        "methodology": "chain-length regression (paper Fig.1/Table I), "
                       "dependent vs independent (Table II), pointer chase "
                       "(Fig.2, Table IV), matrix-unit probes (Table III)",
        "ops": {}, "memory": {}, "mxu": {}, "vpu": {}, "roofline": {},
    }
    alu = docs.get("alu_chain")
    if alu:
        for _, p, m in _cells(alu):
            tag = "dep" if p["dependent"] else "ind"
            table["ops"][f"{p['op']}.{p['dtype']}.{tag}"] = {
                "per_op_ns": m["per_op_ns"],
                "overhead_ns": m["overhead_ns"],
                "cpi_curve": m.get("cpi_curve", {}),
            }
            if p["dtype"] == "float32" and p["dependent"]:
                table["vpu"][f"{p['op']}.f32"] = {
                    "cpi": m["per_op_ns"] * 1e-9 * clock,
                    "measured_per_op_ns": m["per_op_ns"],
                }
    chase = docs.get("memory_chase")
    if chase:
        for _, p, m in _cells(chase):
            if p.get("access", "chase") == "stream":
                table.setdefault("memory_streaming", {})[
                    f"{p['size_kib']}KiB"] = {"gbps": m["gbps"]}
            else:
                table["memory"][str(m["working_set_bytes"])] = {
                    "per_hop_ns": m["per_hop_ns"],
                    "overhead_ns": m["overhead_ns"],
                }
    mxus = docs.get("mxu_shapes")
    if mxus:
        for _, p, m in _cells(mxus):
            mm, nn, kk = p["shape"]
            tag = "dep" if p["dependent"] else "ind"
            row = table["mxu"][f"{p['dtype']}.m{mm}n{nn}k{kk}.{tag}"] = {
                "per_op_us": m["per_op_us"],
                "tflops": m["tflops"],
            }
            if "reps" in m:
                row["reps"] = m["reps"]
    roof = docs.get("roofline_calibration")
    if roof:
        for _, p, m in _cells(roof):
            table["roofline"][p["term"]] = {
                "value": m["value"], "unit": m["unit"],
            }
    return table
