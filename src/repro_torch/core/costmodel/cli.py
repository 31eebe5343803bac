"""Cost-model CLI: ``python -m repro_torch.core.costmodel ...``.

  --calibration hopper_h100          shipped name (hopper_h100, ampere_a100),
                                     JSON path, or campaign results directory
  --census <file>                    price a census: a JSON artifact with a
                                     "census" key or census-shaped keys (HLO
                                     text is refused: the port has no HLO
                                     census)
  --prediction-error                 round-trip every calibration row through
                                     the layers and print the error table
  --demo                             price a canned census — shows the
                                     defaulted-op reporting
  --export PATH                      write the normalized calibration in the
                                     canonical round-trip format
  --hw NAME                          hardware spec override (h100-sxm-80g,
                                     a100-40g)

Everything here is measurement-free: the CLI only loads tables and prices
censuses — no kernels run and nothing compiles — so it answers in
milliseconds (the CI smoke path).
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
from pathlib import Path

from repro_torch.core.costmodel.model import (CostModel, prediction_error_rows,
                                        prediction_error_summary,
                                        save_calibration)
from repro_torch.core.perfmodel.hardware import SPECS

DEFAULT_OUT_DIR = Path("results") / "costmodel"

# a canned census (tiny decode-ish step) so `--demo` needs no compiled
# module: exercises mapped ops, defaulted ops and every predicted term
DEMO_CENSUS = {
    "flops": 4.2e9,
    "hbm_bytes": 1.3e8,
    "collective_bytes_total": 2.0e6,
    "op_histogram": {
        "fusion": 120.0, "dot": 24.0, "add": 40.0, "multiply": 32.0,
        "tanh": 8.0, "exponential": 8.0, "select": 6.0,
        # kinds with no table row -> must show up as defaulted
        "transpose": 10.0, "reshape": 18.0, "copy": 6.0, "iota": 2.0,
        "dynamic-update-slice": 4.0,
    },
}


def _load_census(path: Path) -> dict:
    """A JSON census (per-device numbers).  Anything else is taken for HLO
    text, which only the reference's HLO census (``core/isa/hlo_census``,
    not ported) can read."""
    text = path.read_text()
    if not text.lstrip().startswith("{"):
        raise SystemExit(f"{path}: not a JSON census; HLO text needs the "
                         "HLO census, which the port does not have - write "
                         "the census as JSON (flops/hbm_bytes/op_histogram)")
    doc = json.loads(text)
    if "census" in doc:
        return doc["census"]
    if "op_histogram" in doc or "flops" in doc:
        return doc
    raise SystemExit(f"{path}: JSON has neither a 'census' record nor "
                     "census-shaped keys (flops/op_histogram)")


def _print_prediction(pred) -> None:
    print(f"calibration={pred.calibration} hw={pred.hw} dtype={pred.dtype}")
    for term in ("compute_s", "memory_s", "collective_s",
                 "issue_overhead_s", "step_s"):
        print(f"  {term:18s} {getattr(pred, term):.6e}")
    print(f"  bottleneck         {pred.bottleneck}")
    print(f"  mapped_ops         {pred.mapped_op_count:.0f}")
    print(f"  defaulted_ops      {pred.defaulted_op_count:.0f}")
    for kind, count in sorted(pred.defaulted_ops.items(),
                              key=lambda kv: -kv[1]):
        print(f"    defaulted/{kind:24s} {count:.0f}")


def _print_error_table(model: CostModel) -> int:
    rows = prediction_error_rows(model)
    print("name,predicted,recorded,unit,err_pct")
    for r in rows:
        print(f"prederr/{r['name']},{r['predicted']:.6g},"
              f"{r['recorded']:.6g},{r['unit']},{r['err_pct']:.2f}")
    s = prediction_error_summary(rows)
    print(f"prederr/summary,0,0,,rows={s['rows']};"
          f"max_err_pct={s['max_err_pct']:.2f};"
          f"mean_err_pct={s['mean_err_pct']:.2f};hw={model.hw.name}")
    return 0 if s["max_err_pct"] <= 10.0 else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.costmodel",
        description="calibrated instruction/memory/MXU cost model")
    p.add_argument("--calibration", default="hopper_h100",
                   help="shipped name (hopper_h100, ampere_a100), JSON path, "
                        "or campaign results dir (default: hopper_h100)")
    p.add_argument("--census", metavar="FILE", default=None,
                   help="price this JSON census")
    p.add_argument("--prediction-error", action="store_true",
                   help="print the calibration round-trip error table")
    p.add_argument("--demo", action="store_true",
                   help="price a canned census (defaulted-op smoke)")
    p.add_argument("--export", metavar="PATH", default=None,
                   help="write the normalized calibration (canonical "
                        f"format) — e.g. {DEFAULT_OUT_DIR}/cal.json")
    p.add_argument("--hw", default=None, choices=sorted(SPECS),
                   help="hardware spec override for collective/peak terms")
    p.add_argument("--dtype", default="bf16",
                   help="MXU compute dtype for the census terms")
    return p


def main(argv=None) -> int:
    if hasattr(signal, "SIGPIPE"):   # die quietly when piped into `head`
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    args = build_parser().parse_args(argv)
    hw = SPECS[args.hw] if args.hw else None
    model = CostModel.from_named(args.calibration, hw=hw)

    did = rc = 0
    if args.export:
        out = save_calibration(model.cal, args.export)
        print(f"wrote {out} ({len(model.cal.instructions)} instruction rows, "
              f"{len(model.cal.memory_levels)} memory levels, "
              f"{len(model.cal.mxu_points)} mxu points)")
        did = 1
    if args.prediction_error:
        rc |= _print_error_table(model)
        did = 1
    if args.census:
        _print_prediction(model.predict(_load_census(Path(args.census)),
                                        dtype=args.dtype))
        did = 1
    if args.demo:
        _print_prediction(model.predict(DEMO_CENSUS, dtype=args.dtype))
        did = 1
    if not did:
        cal = model.cal
        print(f"calibration {cal.name} (hardware={cal.hardware!r}, "
              f"clock={cal.clock_hz / 1e6:.0f} MHz): "
              f"{len(cal.instructions)} instruction rows, "
              f"{len(cal.memory_levels)} memory levels, "
              f"{len(cal.mxu_points)} mxu points, "
              f"bandwidth={model.memory.bandwidth_bps / 1e9:.0f} GB/s")
        print("use --census/--demo/--prediction-error/--export "
              "(see --help)", file=sys.stderr)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
