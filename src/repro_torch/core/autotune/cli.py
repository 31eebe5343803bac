"""Autotuner CLI: ``python -m repro_torch.core.autotune <command> ...``
(the port's copy of the reference package's autotuner CLI).

  tune    search launch configs for one/all tunable kernels and persist
          the winners into the cache (analytic by default — runs on CPU
          with no CUDA and is fully deterministic; ``--measure`` adds the
          top-K measured refinement stage on the card, ``--device cpu``
          times the plain versions instead)
  show    list cache entries (optionally one kernel's); rc=1 when a
          ``--kernel`` filter matches nothing — the CI round-trip check
  export  write the full cache document (canonical JSON) to a path

Common flags: ``--cache`` (default results/autotune/cache.json),
``--calibration`` (shipped name, JSON path, or campaign results dir),
``--dtype``, ``--shape axis=N`` (repeatable).

The analytic path builds no tensor: loading tables and pricing censuses
answers in milliseconds, with no CUDA.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys

from repro_torch.core.autotune.cache import DEFAULT_CACHE_PATH, TuningCache
from repro_torch.core.autotune.search import Autotuner
from repro_torch.core.autotune.space import get_tunable, tunable_names


def _parse_shapes(pairs):
    out = {}
    for p in pairs or ():
        if "=" not in p:
            raise SystemExit(f"--shape wants axis=N, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = int(v)
    return out


def _add_common(p):
    p.add_argument("--cache", default=str(DEFAULT_CACHE_PATH),
                   help=f"cache file (default {DEFAULT_CACHE_PATH})")
    p.add_argument("--kernel", action="append", default=None,
                   help="tunable kernel name (repeatable; default: all of "
                        f"{', '.join(tunable_names())})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.autotune",
        description="cost-model-guided kernel autotuner")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("tune", help="search + persist tuned configs")
    _add_common(t)
    t.add_argument("--calibration", default="hopper_h100",
                   help="shipped name, JSON path, or campaign results dir "
                        "(default: hopper_h100)")
    t.add_argument("--dtype", default="bf16")
    t.add_argument("--shape", action="append", metavar="AXIS=N",
                   help="problem-shape override (repeatable; applies to "
                        "every tuned kernel that has the axis)")
    t.add_argument("--top-k", type=int, default=3,
                   help="candidates refined by measurement (default 3)")
    g = t.add_mutually_exclusive_group()
    g.add_argument("--analytic-only", action="store_true",
                   help="rank with the cost model only (the default; the "
                        "flag exists so CI invocations are explicit)")
    g.add_argument("--measure", action="store_true",
                   help="refine the top-K with measured timings on "
                        "--device (the microbench harness's timer)")
    t.add_argument("--device", default=None,
                   help="where --measure times the candidates (default: "
                        "the card; 'cpu' times the plain versions)")

    s = sub.add_parser("show", help="list cache entries")
    _add_common(s)

    e = sub.add_parser("export", help="write the cache document to a path")
    _add_common(e)
    e.add_argument("out", help="output JSON path")
    return p


def _cmd_tune(args) -> int:
    from repro_torch.core.costmodel import CostModel
    cache = TuningCache(args.cache)
    tuner = Autotuner(CostModel.from_named(args.calibration), cache,
                      dtype=args.dtype, measure=bool(args.measure),
                      top_k=args.top_k, device=args.device)
    shapes = _parse_shapes(args.shape)
    kernels = args.kernel or tunable_names()
    tunables = {name: get_tunable(name) for name in kernels}  # fail early
    known = {k for tn in tunables.values() for k in tn.shape_keys}
    unknown = sorted(set(shapes) - known)
    if unknown:
        # a typo'd axis must not silently tune the default shapes
        raise SystemExit(
            f"--shape axes {', '.join(unknown)} not used by "
            f"kernel(s) {', '.join(kernels)}; known axes: "
            f"{', '.join(sorted(known))}")
    for name, tn in tunables.items():
        use = {k: v for k, v in shapes.items() if k in tn.shape_keys}
        res = tuner.tune(name, use or None)
        print(res.summary())
        for row in res.ranked[:5]:
            print(f"    {json.dumps(row['config'], sort_keys=True):48s} "
                  f"predicted={row['predicted_s']:.3e}s "
                  f"({row['bottleneck']}-bound)"
                  + (f" measured={row['measured_s']:.3e}s"
                     if "measured_s" in row else ""))
    print(f"cache: {cache.path} ({len(cache)} entries)")
    return 0


def _cmd_show(args) -> int:
    cache = TuningCache(args.cache)
    kernels = args.kernel
    shown = 0
    for key, entry in cache.items():
        if kernels and entry.get("kernel") not in kernels:
            continue
        shown += 1
        print(f"{key}")
        print(f"    config={json.dumps(entry['config'], sort_keys=True)} "
              f"source={entry.get('source', '?')} "
              f"predicted={entry.get('predicted_s', 0.0):.3e}s "
              f"(default {entry.get('predicted_default_s', 0.0):.3e}s, "
              f"x{entry.get('predicted_speedup', 0.0):.2f})")
    print(f"{shown} entr{'y' if shown == 1 else 'ies'} in {cache.path}")
    if kernels and shown == 0:
        print(f"no entries for kernel(s) {', '.join(kernels)}",
              file=sys.stderr)
        return 1
    return 0


def _cmd_export(args) -> int:
    cache = TuningCache(args.cache)
    out = cache.export(args.out)
    print(f"wrote {out} ({len(cache)} entries)")
    return 0


def main(argv=None) -> int:
    if hasattr(signal, "SIGPIPE"):   # die quietly when piped into `head`
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    args = build_parser().parse_args(argv)
    return {"tune": _cmd_tune, "show": _cmd_show,
            "export": _cmd_export}[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
