"""Schema-versioned, resumable result persistence for campaigns.

One result file per experiment: a JSON document holding campaign metadata
plus one record per completed cell, keyed by the cell's canonical key
(``spec.cell_key``).  The store writes after *every* cell (atomic
tmp+rename), so an interrupted campaign loses at most the in-flight cell
and a rerun skips everything already measured — the property that keeps
multi-hour hardware sweeps reproducible.

The schema is versioned; ``validate`` migrates older documents forward so
downstream consumers (report generator, calibration loader, perf model)
only ever see the current shape.
"""
from __future__ import annotations

import csv
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional

SCHEMA_VERSION = 1

# status values a cell record may carry
STATUS_OK = "ok"
STATUS_ERROR = "error"


def new_document(experiment: str, backend: str, quick: bool,
                 meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    return {
        "schema_version": SCHEMA_VERSION,
        "experiment": experiment,
        "backend": backend,
        "quick": bool(quick),
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "meta": dict(meta or {}),
        "cells": {},
    }


def _migrate(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Forward-migrate older schema versions.  v0 files (pre-versioning)
    carry no per-cell records this code can trust; their metadata survives
    and the cell map starts empty so a rerun re-measures everything."""
    version = doc.get("schema_version", 0)
    if version == 0 and "cells" not in doc:
        doc = {
            "schema_version": SCHEMA_VERSION,
            "experiment": doc.get("experiment", "unknown"),
            "backend": doc.get("backend", doc.get("hardware", "unknown")),
            "quick": bool(doc.get("quick", False)),
            "created": doc.get("created", ""),
            "meta": {},
            "cells": {},
        }
    doc["schema_version"] = SCHEMA_VERSION
    return doc


def validate(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Check (and migrate) a result document; raise ValueError if unusable."""
    if not isinstance(doc, dict):
        raise ValueError("result document must be a JSON object")
    version = doc.get("schema_version", 0)
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"result schema v{version} is newer than supported "
            f"v{SCHEMA_VERSION}; upgrade the repo to read this file")
    if version < SCHEMA_VERSION:
        doc = _migrate(doc)
    for field in ("experiment", "cells"):
        if field not in doc:
            raise ValueError(f"result document missing field {field!r}")
    if not isinstance(doc["cells"], dict):
        raise ValueError("result document 'cells' must be an object")
    for key, rec in doc["cells"].items():
        if "params" not in rec or "metrics" not in rec:
            raise ValueError(f"cell {key!r} missing params/metrics")
    return doc


def load_results(path: os.PathLike | str) -> Dict[str, Any]:
    """Read + validate one campaign result file."""
    return validate(json.loads(Path(path).read_text()))


def load_results_dir(results_dir: os.PathLike | str,
                     experiments: Optional[Iterable[str]] = None
                     ) -> Dict[str, Dict[str, Any]]:
    """Load every ``<experiment>.json`` in a directory -> {experiment: doc}."""
    wanted = set(experiments) if experiments is not None else None
    out: Dict[str, Dict[str, Any]] = {}
    root = Path(results_dir)
    if not root.is_dir():
        return out
    for p in sorted(root.glob("*.json")):
        try:
            doc = load_results(p)
        except (ValueError, json.JSONDecodeError):
            continue   # unrelated JSON (e.g. dry-run artifacts) in the dir
        if wanted is None or doc["experiment"] in wanted:
            out[doc["experiment"]] = doc
    return out


class ResultStore:
    """Incremental writer for one experiment's result file."""

    def __init__(self, path: os.PathLike | str, experiment: str,
                 backend: str = "unknown", quick: bool = False,
                 meta: Optional[Dict[str, Any]] = None):
        self.path = Path(path)
        if self.path.exists():
            doc = load_results(self.path)
            if doc["experiment"] != experiment:
                raise ValueError(
                    f"{self.path} holds results for {doc['experiment']!r}, "
                    f"not {experiment!r}")
            self.doc = doc
        else:
            self.doc = new_document(experiment, backend, quick, meta)

    @property
    def completed(self) -> set[str]:
        """Keys of cells measured successfully (errors are retried)."""
        return {k for k, rec in self.doc["cells"].items()
                if rec.get("status", STATUS_OK) == STATUS_OK}

    @property
    def completed_full(self) -> set[str]:
        """Keys measured successfully with the FULL sweep.  A full campaign
        must not reuse quick-mode measurements (shorter chains, smaller
        shapes), so only these satisfy a quick=False run."""
        return {k for k, rec in self.doc["cells"].items()
                if rec.get("status", STATUS_OK) == STATUS_OK
                and not rec.get("quick", False)}

    def record(self, key: str, params: Dict[str, Any],
               metrics: Dict[str, Any], elapsed_s: float = 0.0,
               status: str = STATUS_OK, error: Optional[str] = None,
               quick: bool = False) -> None:
        rec: Dict[str, Any] = {
            "params": params, "metrics": metrics, "status": status,
            "elapsed_s": float(elapsed_s), "quick": bool(quick),
        }
        if error is not None:
            rec["error"] = error
        self.doc["cells"][key] = rec
        # the document-level flag reflects what the cells actually are
        self.doc["quick"] = any(r.get("quick", False)
                                for r in self.doc["cells"].values())
        self.flush()

    def flush(self) -> None:
        """Atomic write: a crash mid-campaign never corrupts the file."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self.doc, indent=1, sort_keys=False))
        os.replace(tmp, self.path)

    # ----- CSV export --------------------------------------------------------

    def write_csv(self, path: Optional[os.PathLike | str] = None) -> Path:
        out = Path(path) if path else self.path.with_suffix(".csv")
        write_csv(self.doc, out)
        return out


def _scalar(v: Any) -> bool:
    return isinstance(v, (int, float, str, bool)) or v is None


def write_csv(doc: Dict[str, Any], path: os.PathLike | str) -> None:
    """Flatten a result document to CSV: one row per cell, scalar metrics
    as columns, nested metrics (curves, histograms) JSON-encoded."""
    cells = doc["cells"]
    param_cols: list[str] = []
    metric_cols: list[str] = []
    for rec in cells.values():
        for k in rec["params"]:
            if k not in param_cols:
                param_cols.append(k)
        for k in rec["metrics"]:
            if k not in metric_cols:
                metric_cols.append(k)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["experiment", "cell", "status"] + param_cols + metric_cols)
        for key in sorted(cells):
            rec = cells[key]
            row = [doc["experiment"], key, rec.get("status", STATUS_OK)]
            for k in param_cols:
                row.append(spec_fmt(rec["params"].get(k)))
            for k in metric_cols:
                v = rec["metrics"].get(k)
                row.append(v if _scalar(v) else json.dumps(v))
            w.writerow(row)


def spec_fmt(v: Any) -> Any:
    if isinstance(v, (tuple, list)):
        return "x".join(str(x) for x in v)
    return v
