"""CLI for the sharding-plan ranker: the topology choice the serving
cluster makes, inspectable offline.

  python -m repro_torch.sharding --topology 8,8,2048 [--devices 16]

``--topology B,H,ctx`` names the serving shape: global batch, attention
heads (the arch's head count is overridden when it differs; KV heads
shrink with it) and context length.  The first table is ``rank_plans``:
every (data, model) factorization of ``--devices`` priced by the cost
model, ascending by predicted step time.  With more than one device the
second table is ``rank_cluster_topologies``: how many engine replicas the
budget buys (``serve.cluster.ServingCluster.build`` takes ``[0]``),
descending by predicted cluster tok/s.  Nothing runs on a device.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Tuple


def _parse_topology(text: str) -> Tuple[int, int, int]:
    parts = text.split(",")
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(
            f"--topology wants B,H,ctx (three comma-separated ints), "
            f"got {text!r}")
    try:
        b, h, ctx = (int(p) for p in parts)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--topology wants integers, got {text!r}") from None
    if min(b, h, ctx) <= 0:
        raise argparse.ArgumentTypeError("--topology values must be positive")
    return b, h, ctx


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.sharding",
        description=__doc__.splitlines()[0])
    p.add_argument("--calibration", default="hopper_h100",
                   help="named calibration the cost model prices with "
                        "(default hopper_h100)")
    p.add_argument("--topology", type=_parse_topology, required=True,
                   metavar="B,H,ctx",
                   help="serving shape: global batch, attention heads, "
                        "context length")
    p.add_argument("--arch", default="gemma2-2b",
                   help="architecture from the configs zoo "
                        "(default gemma2-2b)")
    p.add_argument("--devices", type=int, default=16,
                   help="device budget to factorize (default 16)")
    p.add_argument("--kind", default="decode",
                   choices=("decode", "prefill", "train"),
                   help="step kind the census prices (default decode)")
    p.add_argument("--max-replicas", type=int, default=None,
                   help="cap the cluster-topology table's replica counts")
    args = p.parse_args(argv)

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.costmodel import CostModel
    from repro_torch.sharding.plans import rank_cluster_topologies, rank_plans

    if args.arch not in ARCHS:
        p.error(f"unknown arch {args.arch!r}; "
                f"available: {', '.join(sorted(ARCHS))}")
    batch, heads, ctx = args.topology
    cfg = ARCHS[args.arch]
    if cfg.n_heads != heads:
        # honor the requested head count; kv heads shrink with it so GQA
        # grouping stays legal
        cfg = reduced(cfg, n_heads=heads,
                      n_kv_heads=min(cfg.n_kv_heads, heads))
    cell = ShapeCell("cli", args.kind, ctx, batch)
    cm = CostModel.from_named(args.calibration)

    print(f"# rank_plans: arch={cfg.name} kind={args.kind} "
          f"B={batch} H={cfg.n_heads} ctx={ctx} "
          f"devices={args.devices} calibration={args.calibration}")
    plans = rank_plans(cfg, cell, args.devices, cm)
    for rank, plan in enumerate(plans):
        marker = "  <- best" if rank == 0 else ""
        print(f"{rank:3d}  {plan.describe()}{marker}")

    if args.devices > 1:
        print(f"\n# rank_cluster_topologies: {args.devices} devices as "
              f"replicas x per-replica mesh (descending predicted tok/s)")
        tops = rank_cluster_topologies(cfg, cell, args.devices, cm,
                                       max_replicas=args.max_replicas)
        for rank, top in enumerate(tops):
            marker = "  <- best" if rank == 0 else ""
            print(f"{rank:3d}  {top.describe()}{marker}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
