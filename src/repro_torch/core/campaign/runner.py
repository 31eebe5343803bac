"""The campaign scheduler: grid -> cells -> measured, persisted results.

Expands an experiment's (quick or full) grid, drops cells a previous run
already completed (resume-skip), checks backend compatibility, runs each
remaining cell through the experiment's runner, and records every
measurement through :class:`repro_torch.core.campaign.results.ResultStore` —
flushed after each cell, so interruption costs at most one cell.

Cell failures are recorded (status=error) and the campaign continues; a
rerun retries failed cells but never re-measures successful ones unless
``force=True``.
"""
from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.campaign import registry as reg
from repro_torch.core.campaign.results import (STATUS_ERROR, STATUS_OK,
                                               ResultStore)
from repro_torch.core.campaign.spec import Experiment

DEFAULT_RESULTS_DIR = Path("results") / "campaign"


@dataclass
class RunReport:
    """What one campaign invocation did (for CLIs and tests)."""
    experiment: str
    path: Optional[Path]
    total_cells: int = 0
    ran: int = 0
    skipped: int = 0
    failed: int = 0
    elapsed_s: float = 0.0
    cell_keys_run: list = field(default_factory=list)

    def summary(self) -> str:
        return (f"{self.experiment}: {self.ran} ran, {self.skipped} skipped "
                f"(already complete), {self.failed} failed, "
                f"{self.elapsed_s:.1f}s -> {self.path}")


def _current_backend(device) -> str:
    """``"gpu"`` for a CUDA device, ``"cpu"`` otherwise: the device the
    caller named, never one found by a probe that falls back."""
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def run(experiment: Union[str, Experiment], *,
        out_dir: Union[str, Path] = DEFAULT_RESULTS_DIR,
        quick: bool = False, force: bool = False,
        only: Optional[Dict[str, Any]] = None,
        store: Optional[ResultStore] = None,
        backend: Optional[str] = None,
        device=None,
        progress: Optional[Callable[[str], None]] = None) -> RunReport:
    """Run (or resume) one experiment campaign.

    ``only`` filters the grid to cells whose params match every given
    key/value (the CLI's ``--filter op=add``).  Passing ``store`` overrides
    the default ``<out_dir>/<name>.json`` location (used by tests and by
    ``tables.calibrate`` when it redirects results).  ``device`` is where
    the cells run: the card by default (``repro_torch.resolve_device``).
    """
    exp = reg.get(experiment) if isinstance(experiment, str) else experiment
    device = resolve_device(device)
    backend = backend or _current_backend(device)
    if not exp.supports_backend(backend):
        raise RuntimeError(
            f"experiment {exp.name!r} requires one of {exp.backends}, "
            f"current backend is {backend!r}")

    if store is None:
        store = ResultStore(Path(out_dir) / f"{exp.name}.json", exp.name,
                            backend=backend, quick=quick)
    doc_backend = store.doc.get("backend", "unknown")
    if doc_backend not in ("unknown", backend):
        if force:   # force re-measures everything, so relabel and proceed
            store.doc["backend"] = backend
        else:
            raise RuntimeError(
                f"{store.path} holds {doc_backend!r} measurements but the "
                f"current backend is {backend!r}; mixing backends in one "
                "result file would corrupt the calibration — rerun with "
                "--force to re-measure, or use a different --out-dir")
    report = RunReport(experiment=exp.name, path=store.path)
    say = progress or (lambda s: None)

    cells = exp.cells(quick=quick)
    if only:
        cells = [c for c in cells
                 if all(str(c.params.get(k)) == str(v)
                        for k, v in only.items())]
    report.total_cells = len(cells)
    # a quick run reuses any good cell; a full run only full-sweep cells
    # (quick mode shortens chains/shapes, so its numbers aren't full results)
    done = store.completed if quick else store.completed_full
    t0 = time.perf_counter()
    for cell in cells:
        if not force and cell.key in done:
            report.skipped += 1
            continue
        say(f"[{exp.name}] {cell.key}")
        t_cell = time.perf_counter()
        try:
            metrics = exp.runner(dict(cell.params), quick=quick,
                                 device=device)
            store.record(cell.key, dict(cell.params), metrics,
                         elapsed_s=time.perf_counter() - t_cell,
                         status=STATUS_OK, quick=quick)
            report.ran += 1
            report.cell_keys_run.append(cell.key)
        except Exception as e:  # record + continue: one bad cell must not
            store.record(cell.key, dict(cell.params), {},   # kill a campaign
                         elapsed_s=time.perf_counter() - t_cell,
                         status=STATUS_ERROR,
                         error=f"{type(e).__name__}: {e}\n"
                               f"{traceback.format_exc(limit=3)}",
                         quick=quick)
            report.failed += 1
            say(f"[{exp.name}] {cell.key} FAILED: {e}")
    report.elapsed_s = time.perf_counter() - t0
    store.write_csv()
    return report


def run_many(names, **kwargs) -> Dict[str, RunReport]:
    """Run several experiments back to back (the `calibrate` path)."""
    return {n: run(n, **kwargs) for n in names}
