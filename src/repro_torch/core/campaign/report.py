"""Campaign results -> the paper's tables and the calibration table (the
port's copy of ``repro.core.campaign.report``).

Every function here consumes only validated result documents
(``repro_torch.core.campaign.results``), no re-measurement, so a table can
be rebuilt from the JSON artifacts alone, on any machine.  Rows keep the
reference's CSV shape ``name,us_per_call,derived`` and its row names
(``table1/...`` to ``table5/...``, ``roofline/...``, ``autotune/...``,
``paged_serve/...``, ``decode_hotpath/...``, ``telemetry/...``); over a document with the
reference's keys a row is the reference's row.  ``decode_longctx/...``
rows are the card's: the sweep is over the kernel's token chunk, not the
reference's split factor, and the time is the kernel's own.  The port's
cells carry more: an ``isa_mapping`` row adds ``expansion=`` (the SASS
beyond the copy baseline) and a ``decode_hotpath`` row on the card
``baseline_peak_bytes=`` and ``fused_peak_bytes=``.

``table_for`` renders the ported experiments' documents and refuses the
others (``traffic_scaling``, ``sharded_decode``, ``chaos_serving``),
naming the experiment.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

Row = Tuple[str, float, str]   # (name, us_per_call, derived)


def _cells(doc: Mapping[str, Any], ok_only: bool = True):
    for key in sorted(doc["cells"]):
        rec = doc["cells"][key]
        if ok_only and rec.get("status", "ok") != "ok":
            continue
        yield key, rec["params"], rec["metrics"]


def cpi_table(doc: Mapping[str, Any]) -> List[Row]:
    """Tables I/II from an ``alu_chain`` result file: the chain-length CPI
    convergence curve plus dependent/independent per-op latency."""
    rows: List[Row] = []
    for _, p, m in _cells(doc):
        tag = "dep" if p["dependent"] else "ind"
        name = f"table2/{p['op']}.{p['dtype']}.{tag}"
        rows.append((name, m["per_op_ns"] / 1e3,
                     f"overhead_us={m['overhead_ns'] / 1e3:.2f}"))
        for k in sorted(m.get("cpi_curve", {}), key=int):
            rows.append((f"table1/{p['op']}.{p['dtype']}.{tag}/K={k}",
                         m["times_us"][m["lengths"].index(int(k))]
                         if int(k) in m.get("lengths", []) else 0.0,
                         f"t(K)/(K*t_inf)={m['cpi_curve'][k]:.2f}"))
    return rows


def mxu_table(doc: Mapping[str, Any]) -> List[Row]:
    """Table III from an ``mxu_shapes`` result file."""
    rows: List[Row] = []
    for _, p, m in _cells(doc):
        mm, nn, kk = p["shape"]
        tag = "dep" if p["dependent"] else "ind"
        rows.append((f"table3/{p['dtype']}.m{mm}n{nn}k{kk}.{tag}",
                     m["per_op_us"], f"tflops={m['tflops']:.3f}"))
    return rows


def memory_table(doc: Mapping[str, Any]) -> List[Row]:
    """Table IV from a ``memory_chase`` result file: chase latency per
    working-set size plus the contrasting streaming-read bandwidth."""
    rows: List[Row] = []
    for _, p, m in _cells(doc):
        if p.get("access", "chase") == "stream":
            rows.append((f"table4/streaming_read_{p['size_kib']}KiB", 0.0,
                         f"GBps={m['gbps']:.2f}"))
        else:
            rows.append((f"table4/chase_{p['size_kib']}KiB",
                         m["per_hop_ns"] / 1e3,
                         f"per_hop_ns={m['per_hop_ns']:.1f}"))
    return rows


def _ops(hist: Mapping[str, int]) -> str:
    return ",".join(f"{k}x{v}" for k, v in hist.items())


def isa_table(doc: Mapping[str, Any]) -> List[Row]:
    """Table V from an ``isa_mapping`` result file; the port's cells add
    the SASS expansion over the copy baseline."""
    rows: List[Row] = []
    for _, p, m in _cells(doc):
        derived = (f"src_ops={m['n_source_ops']};"
                   f"opt_ops={m['n_optimized_ops']};"
                   f"top={_ops(m.get('top_ops', {}))};flops={m['flops']}")
        if "sass_expansion" in m:
            derived += f";expansion={_ops(m['sass_expansion'])}"
        rows.append((f"table5/{p['case']}", 0.0, derived))
    return rows


def roofline_table(doc: Mapping[str, Any]) -> List[Row]:
    """Achieved-peak terms from a ``roofline_calibration`` result file."""
    rows: List[Row] = []
    for _, p, m in _cells(doc):
        rows.append((f"roofline/{p['term']}", 0.0,
                     f"value={m['value']:.3f};unit={m['unit']};"
                     f"{m.get('detail', '')}"))
    return rows


def autotune_table(doc: Mapping[str, Any]) -> List[Row]:
    """Tuning outcomes from an ``autotune`` result file: predicted (and,
    for measured cells, measured) best config + speedup over default."""
    import json as _json

    rows: List[Row] = []
    for _, p, m in _cells(doc):
        derived = (f"best={_json.dumps(m['best_config'], sort_keys=True)};"
                   f"default_s={m['predicted_default_s']:.3e};"
                   f"speedup={m['predicted_speedup']:.2f};"
                   f"candidates={m['n_candidates']}")
        if "measured_best_s" in m:
            derived += f";measured_s={m['measured_best_s']:.3e}"
            if "measured_speedup" in m:
                derived += f";measured_speedup={m['measured_speedup']:.2f}"
        rows.append((f"autotune/{p['kernel']}.{p['dtype']}.{p['mode']}",
                     m["predicted_best_s"] * 1e6, derived))
    return rows


def paged_serve_table(doc: Mapping[str, Any]) -> List[Row]:
    """Slot-vs-paged serving comparison from a ``paged_serve`` result
    file: throughput side by side with resident KV bytes, plus the
    correctness and accounting columns."""
    rows: List[Row] = []
    for _, p, m in _cells(doc):
        name = f"paged_serve/bs{p['block_size']}"
        derived = (f"slot_tok_s={m['slot_tok_per_s']:.1f};"
                   f"paged_tok_s={m['paged_tok_per_s']:.1f};"
                   f"slot_kv_bytes={m['slot_kv_bytes']};"
                   f"paged_kv_bytes={m['paged_kv_bytes']};"
                   f"kv_ratio={m['kv_bytes_ratio']:.3f};"
                   f"identical={m['identical_tokens']};"
                   f"completed={m['completed_paged']}/{m['completed_slot']};"
                   f"preemptions={m['preemptions']};"
                   f"blocks_leaked={m['blocks_leaked']}")
        rows.append((name, 0.0, derived))
    return rows


def decode_hotpath_table(doc: Mapping[str, Any]) -> List[Row]:
    """Legacy-vs-fused decode hot path from a ``decode_hotpath`` result
    file: throughput and host-sync rate side by side, the correctness
    column, the cost model's predicted byte savings and, from the card,
    each path's peak device memory."""
    rows: List[Row] = []
    for _, p, m in _cells(doc):
        derived = (f"baseline_tok_s={m['baseline_tok_per_s']:.1f};"
                   f"fused_tok_s={m['fused_tok_per_s']:.1f};"
                   f"speedup={m['speedup']:.2f};"
                   f"baseline_syncs_per_step={m['baseline_syncs_per_step']:.2f};"
                   f"fused_syncs_per_step={m['fused_syncs_per_step']:.2f};"
                   f"identical={m['identical_tokens']};"
                   f"kv_bytes={m['fused_kv_bytes']};"
                   f"pred_hbm_saved={m['predicted_hbm_bytes_saved']:.3e};"
                   f"pred_boundary_saved={m['predicted_boundary_bytes_saved']:.3e}")
        for key in ("baseline_peak_bytes", "fused_peak_bytes"):
            if key in m:
                derived += f";{key}={m[key]}"
        rows.append((f"decode_hotpath/{p['engine']}", 0.0, derived))
    return rows


def decode_longctx_table(doc: Mapping[str, Any]) -> List[Row]:
    """Long-context decode evidence from a ``decode_longctx`` result file:
    tok/s at this chunk vs the default chunk, the speedup of the analytic
    tuner's chunk at the same context, the cost model's predicted speedup
    and best chunk, and the token-equality column; ``us_per_call`` is the
    kernel's time."""
    rows: List[Row] = []
    for _, p, m in _cells(doc):
        name = f"decode_longctx/ctx{p['ctx']}.c{p['chunk_tokens']}"
        derived = (f"tok_s={m['tok_s']:.1f};"
                   f"default_tok_s={m['default_tok_s']:.1f};"
                   f"speedup={m['speedup']:.2f};"
                   f"tuned_chunk={m['tuned_chunk']};"
                   f"tuned_speedup={m['tuned_speedup']:.2f};"
                   f"pred_speedup={m['predicted_speedup']:.2f};"
                   f"pred_best_chunk={m['predicted_best_chunk']};"
                   f"identical={m['identical_tokens']};"
                   f"max_abs_err={m['max_abs_err_vs_ref']:.3e}")
        rows.append((name, float(m["kernel_us"]), derived))
    return rows


def telemetry_table(doc: Mapping[str, Any]) -> List[Row]:
    """Telemetry-scenario evidence from a ``telemetry_replay`` result
    file: the drift row shows the recalibration count and the error
    before/after (the 10% gate), the overload row shows measured p99
    against the SLO target next to the ungated baseline's spike — plus
    the token-equality column CI greps on both."""
    rows: List[Row] = []
    for _, p, m in _cells(doc):
        if p["scenario"] == "drift":
            derived = (f"events={m['n_events']};"
                       f"pre_err={m['pre_error']:.3f};"
                       f"post_err={m['post_error']:.3f};"
                       f"gate={m['gate']:.2f};"
                       f"identical={m['tokens_ok']};"
                       f"completed={m['completed']}/{m['n_requests']}")
        else:
            derived = (f"p99_s={m['p99_s']:.2f};"
                       f"target_s={m['target_p99_s']:.2f};"
                       f"baseline_p99_s={m['baseline_p99_s']:.2f};"
                       f"slo_held={m['slo_held']};"
                       f"deferred={m['deferred']};"
                       f"fifo={m['admission_fifo']};"
                       f"identical={m['tokens_ok']};"
                       f"completed={m['completed']}/{m['n_requests']}")
        rows.append((f"telemetry/{p['scenario']}", 0.0, derived))
    return rows


_TABLE_FOR = {
    "alu_chain": cpi_table,
    "mxu_shapes": mxu_table,
    "memory_chase": memory_table,
    "isa_mapping": isa_table,
    "roofline_calibration": roofline_table,
    "autotune": autotune_table,
    "paged_serve": paged_serve_table,
    "decode_hotpath": decode_hotpath_table,
    "decode_longctx": decode_longctx_table,
    "telemetry_replay": telemetry_table,
}
def table_for(doc: Mapping[str, Any]) -> List[Row]:
    """Dispatch a result document to its paper-table renderer; raises on
    an experiment the port does not render, naming it."""
    exp = doc["experiment"]
    try:
        return _TABLE_FOR[exp](doc)
    except KeyError:
        raise ValueError(f"no table for experiment {exp!r}: not ported; "
                         f"ported: {sorted(_TABLE_FOR)}") from None


def render_rows(rows: Iterable[Row], file=None, header: bool = True) -> None:
    file = file or sys.stdout
    if header:
        print("name,us_per_call,derived", file=file)
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived}", file=file)


def render_result_files(paths, file=None) -> None:
    """Load + render paper tables from result files alone: the body of
    ``python -m repro_torch.core.campaign report``."""
    from repro_torch.core.campaign.results import load_results

    first = True
    for path in paths:
        try:
            doc = load_results(path)
            rows = table_for(doc)
        except (OSError, ValueError) as e:   # ValueError covers bad JSON too
            raise SystemExit(f"{path}: {e}") from None
        render_rows(rows, file=file, header=first)
        first = False


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
