"""CLI for the port's telemetry layer: CI smokes + the docs consistency
gate (the port's copy of ``repro.serve.telemetry.cli``).

Subcommands (``python -m repro_torch.serve.telemetry <cmd>``):

``smoke``
    Run the deterministic drift scenario (and, with ``--overload``, the
    SLO overload scenario) on the sim harness and FAIL (rc=2) unless the
    acceptance properties hold: >=1 recalibration event, post-
    recalibration error under the gate, exact tokens — and for overload,
    p99 at/under the target with newest-first shedding.  The fake model's
    tensors live on ``--device``: the card unless the caller asks for the
    CPU (``--device cpu``, the CI smoke), as at every entry point of the
    port.

``checkdocs``
    Verify ``docs/reference/metrics.md`` carries a row for every field
    of the telemetry schema (``metrics.schema_field_names``) and that
    the snapshot kind/version strings in the doc match the code.  Pure
    stdlib — the docs CI job runs it without importing torch.  The
    port's records carry the reference's fields, so the one document
    serves both packages.

``show``
    Pretty-print a saved telemetry snapshot's summary block (loudly
    refusing non-snapshot JSON).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.serve.telemetry import metrics

REPO_ROOT = Path(__file__).resolve().parents[4]
METRICS_DOC = REPO_ROOT / "docs" / "reference" / "metrics.md"


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}")
    return 2


def cmd_smoke(args) -> int:
    from repro_torch import resolve_device
    from repro_torch.serve.telemetry.scenarios import (run_drift_scenario,
                                                       run_overload_scenario)
    device = resolve_device(args.device)
    rc = 0
    res = run_drift_scenario(device=device)
    print(json.dumps({k: v for k, v in res.items() if k != "events"},
                     indent=1, default=str))
    if res["n_events"] < 1:
        rc = _fail("drift scenario emitted no recalibration event")
    elif res["post_error"] is None or res["post_error"] >= res["gate"]:
        rc = _fail(f"post-recalibration error {res['post_error']} not "
                   f"under the {res['gate']:.0%} gate")
    elif not res["tokens_ok"] or res["completed"] != res["n_requests"]:
        rc = _fail("recalibration changed served tokens")
    else:
        print(f"drift smoke OK: {res['n_events']} event(s), error "
              f"{res['pre_error']:.2f} -> {res['post_error']:.3f}")
    if args.overload:
        res = run_overload_scenario(device=device)
        print(json.dumps({k: v for k, v in res.items() if k != "summary"},
                         indent=1, default=str))
        if not res["slo_held"]:
            rc = _fail(f"p99 {res['p99_s']:.2f}s exceeded the "
                       f"{res['target_p99_s']:.2f}s SLO")
        elif not (res["deferred"] > 0 and res["admission_fifo"]):
            rc = _fail("overload did not shed newest-first")
        elif not res["tokens_ok"] or res["completed"] != res["n_requests"]:
            rc = _fail("overload shedding changed admitted tokens")
        else:
            print(f"overload smoke OK: p99 {res['p99_s']:.2f}s <= "
                  f"{res['target_p99_s']:.2f}s at "
                  f"{res['load_factor']}x load "
                  f"(ungated baseline {res['baseline_p99_s']:.2f}s)")
    return rc


def cmd_checkdocs(args) -> int:
    doc_path = Path(args.doc) if args.doc else METRICS_DOC
    if not doc_path.exists():
        return _fail(f"{doc_path} does not exist")
    text = doc_path.read_text()
    missing = [name for name in metrics.schema_field_names()
               if f"`{name}`" not in text]
    rc = 0
    if missing:
        rc = _fail(f"{doc_path.name} is missing rows for schema fields: "
                   f"{', '.join(missing)} — regenerate from "
                   "repro_torch.serve.telemetry.metrics (STEP_FIELDS / "
                   "REQUEST_FIELDS)")
    for token in (metrics.SNAPSHOT_KIND,
                  f"version {metrics.SNAPSHOT_VERSION}"):
        if token not in text:
            rc = _fail(f"{doc_path.name} does not mention {token!r} — the "
                       "documented snapshot schema is out of date")
    if rc == 0:
        n = len(metrics.schema_field_names())
        print(f"checkdocs OK: all {n} schema fields documented in "
              f"{doc_path}")
    return rc


def cmd_show(args) -> int:
    doc = metrics.load_snapshot(args.snapshot)
    print(f"telemetry snapshot v{doc['version']} "
          f"(capacity {doc['capacity']}, {len(doc['steps'])} steps, "
          f"{len(doc['requests'])} requests, "
          f"{len(doc['events'])} events)")
    print(json.dumps(doc["summary"], indent=1))
    for e in doc["events"]:
        print(f"  recalibration: {e['kind']}/{e['bucket']} "
              f"ratio={e['ratio']:.3f} applied={e['applied']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.telemetry",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sm = sub.add_parser("smoke", help="run the sim drift (+overload) "
                        "acceptance scenarios; rc!=0 on failure")
    sm.add_argument("--overload", action="store_true",
                    help="also run the SLO overload scenario")
    sm.add_argument("--device", default=None,
                    help="the fake model's device (default: the card; "
                    "'cpu' runs on the host)")
    sm.set_defaults(fn=cmd_smoke)
    cd = sub.add_parser("checkdocs", help="fail unless every schema field "
                        "is documented in docs/reference/metrics.md")
    cd.add_argument("--doc", default=None,
                    help="override the reference doc path")
    cd.set_defaults(fn=cmd_checkdocs)
    sh = sub.add_parser("show", help="summarize a saved snapshot")
    sh.add_argument("snapshot")
    sh.set_defaults(fn=cmd_show)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
