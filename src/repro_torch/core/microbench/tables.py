"""Latency tables: load shipped calibrations, run the measurement campaigns,
persist refreshed tables (the paper's deliverable is exactly such a table).

Measurement is delegated to the campaign runner
(``repro_torch.core.campaign``): ``calibrate`` runs the four calibration
experiments through the scheduler, so a partially-finished calibration
resumes instead of restarting, and converts the persisted results into the
calibration-table format of ``repro``'s cost model.  On the card the table
carries the SM clock the probe kernels measured (``clock_mhz``), and its
``vpu`` CPI rows are in those cycles.
"""
from __future__ import annotations

import json
import statistics
from pathlib import Path
from typing import Dict, Iterable, Optional

CALIB_DIR = Path(__file__).resolve().parents[1] / "calibration"

# the experiments whose results make up a calibration table
CALIBRATION_EXPERIMENTS = ("alu_chain", "memory_chase", "mxu_shapes",
                           "roofline_calibration")


def load_table(name: str) -> Dict:
    return json.loads((CALIB_DIR / f"{name}.json").read_text())


def ampere_table() -> Dict:
    """The paper's own A100 numbers (Tables II-V), shipped with the repo."""
    return load_table("ampere_a100")


def measured_clock_hz(docs) -> Optional[float]:
    """The median SM clock the probe kernels measured over the ALU cells
    (None where the cells carry none, as on the CPU)."""
    doc = docs.get("alu_chain") or {"cells": {}}
    clocks = [rec["metrics"]["clock_hz"] for rec in doc["cells"].values()
              if rec.get("status", "ok") == "ok"
              and rec["metrics"].get("clock_hz")]
    return statistics.median(clocks) if clocks else None


def table_from_results(results_dir: Path | str,
                       experiments: Iterable[str] = CALIBRATION_EXPERIMENTS,
                       clock_hz: Optional[float] = None) -> Dict:
    """Build a calibration table from campaign result files alone - no
    re-measurement."""
    from repro_torch.core.campaign import report as campaign_report
    from repro_torch.core.campaign.results import load_results_dir

    docs = load_results_dir(results_dir, experiments)
    if not docs:
        raise FileNotFoundError(
            f"no campaign results for {tuple(experiments)} in {results_dir}; "
            "run `python -m repro_torch.core.campaign run <experiment>` first")
    return campaign_report.calibration_from_results(
        docs, clock_hz=clock_hz or measured_clock_hz(docs))


def calibrate(out_path: Optional[Path] = None, quick: bool = True,
              results_dir: Optional[Path | str] = None,
              device=None) -> Dict:
    """Run the calibration campaigns on ``device`` (default: the card) and
    emit a table in the calibration format.

    Campaign results persist under ``results_dir`` (default
    ``results/campaign``); already-measured cells are skipped on rerun, so
    an interrupted calibration resumes where it stopped.
    """
    from repro_torch.core.campaign import report as campaign_report
    from repro_torch.core.campaign import runner as campaign_runner
    from repro_torch.core.campaign.results import load_results

    results_dir = Path(results_dir or campaign_runner.DEFAULT_RESULTS_DIR)
    reports = campaign_runner.run_many(CALIBRATION_EXPERIMENTS,
                                       out_dir=results_dir, quick=quick,
                                       device=device)
    docs = {name: load_results(rep.path) for name, rep in reports.items()}
    clock = measured_clock_hz(docs)
    table = campaign_report.calibration_from_results(docs, clock_hz=clock)
    if clock:
        table["clock_mhz"] = clock / 1e6
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(table, indent=1))
    return table
