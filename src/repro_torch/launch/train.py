"""Train a model through the port's loop (``repro_torch.train.loop``).

  python -m repro_torch.launch.train --arch gemma2-2b --steps 3            # full width, on the card
  python -m repro_torch.launch.train --arch rwkv6-1.6b --reduced --device cpu

``global_batch=8`` and ``seq_len=64``, as the reference's launcher; random
weights from ``--seed``; AdamW or Adafactor as the config says; one card.
``--reduced`` (the reduced config, the counterpart of the reference's
``--host-mesh``) runs anywhere; ``--device cpu`` runs the plain versions
of the kernels on the host.  ``--dry-run`` (lower and price without
running) and ``--multi-pod`` need the sharding half of the port and exit
with status 2, naming the ROADMAP item they wait on.  Every family the
port evaluates trains: the dense family, rwkv6 and hymba (their
recurrences' backward kernels on the card).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    if args.dry_run or args.multi_pod:
        print(f"repro_torch.launch.train: {'--dry-run' if args.dry_run else '--multi-pod'}"
              " waits on the sharding half of the port (ROADMAP queue 1 item 7: "
              "meshes, sharded params) and HLO-free step pricing (ROADMAP: "
              "'HLO dry-run pricing')", file=sys.stderr)
        return 2

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.zoo import build_model
    from repro_torch.train.loop import train

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg, device=args.device)
    res = train(model, num_steps=args.steps, global_batch=8, seq_len=64,
                ckpt_dir=args.ckpt_dir, seed=args.seed,
                hooks=[lambda s, m: print(f"step {s} loss "
                                          f"{float(m['loss']):.4f}")])
    print(f"done: {res.steps_run} steps, final loss {res.final_loss:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
