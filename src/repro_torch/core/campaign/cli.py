"""Command-line front end: ``python -m repro_torch.core.campaign <cmd> ...``.

  list                         show registered experiments + cost estimates
  run <experiment> [...]       run/resume one campaign (or ``all``)
  report <result.json> ...     regenerate the paper's tables from result
                               files (CSV ``name,us_per_call,derived``)
  calibrate [...]              run the calibration campaigns and emit a
                               calibration table

``run`` and ``calibrate`` take ``--device`` (default ``cuda``: the probe
kernels on the card; ``cpu`` runs their plain versions).
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
from pathlib import Path

from repro_torch.core.campaign import registry as reg
from repro_torch.core.campaign import report as report_mod
from repro_torch.core.campaign import runner as runner_mod


def _parse_filters(pairs):
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"--filter expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def cmd_list(args) -> int:
    quick = args.quick
    print(f"{'experiment':24s} {'cells':>6s} {'est_cost':>9s}  description")
    for name in reg.names():
        exp = reg.get(name)
        n = len(exp.cells(quick=quick))
        print(f"{name:24s} {n:6d} {exp.estimated_cost_s(quick):8.0f}s"
              f"  {exp.description}")
    return 0


def cmd_run(args) -> int:
    names = reg.names() if args.experiment == "all" else [args.experiment]
    for name in names:
        if name not in reg.REGISTRY:
            raise SystemExit(f"unknown experiment {name!r}; available: "
                             f"{', '.join(reg.names())} (or 'all')")
    rc = 0
    for name in names:
        rep = runner_mod.run(
            name, out_dir=args.out_dir, quick=args.quick, force=args.force,
            only=_parse_filters(args.filter), device=args.device,
            progress=print if args.verbose else None)
        print(rep.summary())
        rc = rc or (1 if rep.failed else 0)
    return rc


def cmd_report(args) -> int:
    report_mod.render_result_files(args.results)
    return 0


def cmd_calibrate(args) -> int:
    from repro_torch.core.microbench import tables
    table = tables.calibrate(out_path=args.out, quick=args.quick,
                             results_dir=args.out_dir, device=args.device)
    if not args.out:
        json.dump(table, sys.stdout, indent=1)
        print()
    else:
        print(f"wrote {args.out} "
              f"({len(table['ops'])} op rows, {len(table['mxu'])} mxu rows)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.campaign",
        description="the port's microbenchmark campaign runner")
    sub = p.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("list", help="show registered experiments")
    lp.add_argument("--quick", action="store_true",
                    help="size estimates for the --quick grids")
    lp.set_defaults(fn=cmd_list)

    rp = sub.add_parser("run", help="run/resume one experiment (or 'all')")
    rp.add_argument("experiment")
    rp.add_argument("--quick", action="store_true",
                    help="reduced grid + shorter sweeps (CI smoke mode)")
    rp.add_argument("--force", action="store_true",
                    help="re-measure cells even if already completed")
    rp.add_argument("--out-dir", default=str(runner_mod.DEFAULT_RESULTS_DIR),
                    help="result directory (default: results/campaign)")
    rp.add_argument("--filter", action="append", metavar="KEY=VALUE",
                    help="restrict the grid (repeatable), e.g. --filter op=add")
    rp.add_argument("--device", default="cuda",
                    help="cuda (the probe kernels, default) or cpu")
    rp.add_argument("--verbose", "-v", action="store_true")
    rp.set_defaults(fn=cmd_run)

    pp = sub.add_parser("report",
                        help="regenerate paper tables from result files")
    pp.add_argument("results", nargs="+", type=Path)
    pp.set_defaults(fn=cmd_report)

    cp = sub.add_parser("calibrate",
                        help="run calibration campaigns, emit a latency table")
    cp.add_argument("--quick", action="store_true")
    cp.add_argument("--out", default=None, help="calibration table path")
    cp.add_argument("--out-dir", default=str(runner_mod.DEFAULT_RESULTS_DIR))
    cp.add_argument("--device", default="cuda",
                    help="cuda (the probe kernels, default) or cpu")
    cp.set_defaults(fn=cmd_calibrate)
    return p


def main(argv=None) -> int:
    # die quietly when piped into `head`/`grep -q` instead of tracebacking
    if hasattr(signal, "SIGPIPE"):
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
