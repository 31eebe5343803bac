"""Serve a model through the port's slot engine, or its paged engine.

  python -m repro_torch.launch.serve --arch gemma2-2b              # slot engine, full width, on the card
  python -m repro_torch.launch.serve --arch gemma2-2b --paged      # paged engine
  python -m repro_torch.launch.serve --arch gemma2-2b --profile    # + where the time goes
  python -m repro_torch.launch.serve --arch gemma2-2b --reduced --device cpu
  python -m repro_torch.launch.serve --arch rwkv6-1.6b             # or hymba-1.5b: slot engine only

The traffic is chip_smoke.py's: 8 requests of 16 to 900 prompt tokens
(hymba: to 863, so its 128 meta tokens and the new tokens fit), 32 new
tokens each, through ``ServingEngine(max_batch=8, max_len=1024)`` or,
with ``--paged``, ``PagedServingEngine(max_batch=8, max_len=1024,
block_size=16, chunk_size=64)``, which serves the dense family only
(with rwkv6 or hymba it raises ``NotImplementedError``).  Weights are
random, drawn from ``--seed``; so are the prompts.  After a one-request
warm-up (kernel build, library start-up) the traffic is served once,
timed step by step; one JSON line reports it.  With ``--profile`` it is served again under
``torch.profiler``, which adds the device's busy share of the wall time,
the kernels by device time (the twelve largest, and the port's own
attention kernels by source), and the engine's spans (``prefill`` or
``prefill_chunk``, ``decode_step``, ``sync``) with their host time and
their kernels' time.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time


def _prefill_work(stats):
    """Prefill work done so far: chunks (paged) or whole prefills (slot)."""
    return stats.prefill_chunks + stats.prefills


def _serve(model, params, prompts, paged):
    """Serve ``prompts`` to the end; returns the stats, the wall time and
    each step's (wall ms, prefill chunks or prefills run in it)."""
    import torch

    from repro_torch.serve.engine import PagedServingEngine, ServingEngine

    if paged:
        eng = PagedServingEngine(model, params, max_batch=8,
                                 max_len=MAX_LEN, block_size=16,
                                 chunk_size=64)
    else:
        eng = ServingEngine(model, params, max_batch=8, max_len=MAX_LEN)
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    steps = []
    t_run = time.perf_counter()
    while True:
        t0, c0 = time.perf_counter(), _prefill_work(eng.stats)
        active = eng.step()
        steps.append((1e3 * (time.perf_counter() - t0),
                      _prefill_work(eng.stats) - c0))
        if active == 0 and not eng.queue:
            break
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    if paged:
        eng.allocator.check()
    return eng.stats, wall, steps


SPANS = ("prefill", "prefill_chunk", "decode_step", "sync")
# the port's kernels that serving runs, by source (``kernels/csrc/``), as
# the profiler names them (``flash_attention`` counts both flash sources)
PORT_KERNELS = ("paged_attention", "flash_attention")
MAX_NEW = 32
MAX_LEN = 1024


def _profile(model, params, prompts, paged):
    """Serve again under ``torch.profiler``: the device's busy share of the
    wall time (union of kernel intervals), the kernels by device time, and
    per engine span its host time and the device time of its kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if model.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        _, wall, _ = _serve(model, params, prompts, paged)
    events = prof.events()
    kernels = [e for e in events if e.device_type != DeviceType.CPU
               and not e.is_user_annotation]
    busy_us, end = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        lo = max(e.time_range.start, end)
        if e.time_range.end > lo:
            busy_us += e.time_range.end - lo
        end = max(end, e.time_range.end)
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    port = {}
    for name, (n, us) in by_name.items():
        src = next((s for s in PORT_KERNELS if s in name), None)
        if src is not None:
            c, t = port.get(src, (0, 0.0))
            port[src] = (c + n, t + us)
    spans = {s: {"calls": 0, "host_ms": 0.0, "kernel_ms": 0.0}
             for s in SPANS}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in spans:
            d = spans[e.name]
            d["calls"] += 1
            d["host_ms"] += e.cpu_time_total / 1e3
            d["kernel_ms"] += e.device_time_total / 1e3
    return {"profiled_wall_s": wall, "kernel_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernel_launches": len(kernels),
            "kernels": [{"name": n[:90], "calls": c, "device_ms": us / 1e3}
                        for n, (c, us) in top],
            "port_kernels": {s: {"calls": c, "device_ms": us / 1e3}
                             for s, (c, us) in sorted(port.items())},
            "spans": spans}


def _median(xs):
    return statistics.median(xs) if xs else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (raises without one)")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family config instead of full width")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged engine (block pool + "
                         "chunked prefill) instead of the slot engine")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.zoo import build_model

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    rng = np.random.default_rng(args.seed)
    longest = min(900, MAX_LEN - cfg.meta_tokens - MAX_NEW - 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(16, longest + 1, size=8)]
    # warm-up: builds the kernels and initialises the libraries
    _serve(model, params, prompts[:1], args.paged)
    stats, secs, steps = _serve(model, params, prompts, args.paged)
    out = {"arch": cfg.name, "engine": "paged" if args.paged else "slot",
           "device": str(model.device),
           "layers": cfg.n_layers, "prompt_tokens": int(sum(map(len, prompts))),
           "completed": stats.completed,
           "decoded_tokens": stats.decoded_tokens,
           "prefills": stats.prefills,
           "prefill_chunks": stats.prefill_chunks,
           "decode_dispatches": stats.decode_dispatches,
           "preemptions": stats.preemptions, "steps": stats.steps,
           "host_syncs": stats.host_syncs, "wall_s": secs,
           "decoded_tok_per_s": stats.decoded_tokens / secs,
           "median_decode_only_step_ms": _median(
               [ms for ms, c in steps if c == 0]),
           "median_step_with_prefill_ms": _median(
               [ms for ms, c in steps if c > 0])}
    if args.profile:
        out["profile"] = _profile(model, params, prompts, args.paged)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
