"""Memory-hierarchy pointer chase (the paper's section IV-B, Fig. 2/3,
Table IV).

A random-cycle index array forces serially-dependent loads, exactly like the
paper's linked-list chase; sweeping the working-set size walks the levels of
the memory hierarchy.  On the card ``run_chase`` drives the
``pointer_chase`` kernel in global memory under ``.ca`` (cache at every
level), so the working-set sweep walks L1, L2 and HBM.
The per-hop latency comes from the regression of the kernel's ``clock64()``
cycles over hop counts, divided by the SM clock it measured; the intercept
from CUDA events.  On the CPU the plain chase is timed with
``perf_counter``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.microbench.harness import (clock_hz, fit_latency,
                                                 steady_slope, time_fn,
                                                 time_kernel)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import pointer_chase_plain

# working sets up to the H100's 50 MB L2 are warmed before the chase; the
# L2 is flushed before every launch by writing a buffer well past its size,
# so a larger set is read from HBM (each launch follows the same hops from
# index 0, which would otherwise stay L2-resident)
WARM_MAX_BYTES = 50 * 10 ** 6
FLUSH_BYTES = 128 * 2 ** 20
# where the card's chase reads: device memory, cached at every level
CACHE_OP = "ca"


def _random_cycle(n: int, seed: int = 0) -> np.ndarray:
    """A single n-cycle permutation: chase visits every slot exactly once."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    nxt = np.empty(n, np.int32)
    nxt[order[:-1]] = order[1:]
    nxt[order[-1]] = order[0]
    return nxt


@dataclass
class ChaseResult:
    working_set_bytes: int
    hops: List[int]
    times_s: List[float]
    overhead_s: float
    per_hop_s: float
    # on the card: median in-kernel cycles per hop count, their slope, and
    # the SM clock the kernel measured
    cycles: Optional[List[float]] = None
    cycles_per_hop: Optional[float] = None
    clock_hz: Optional[float] = None

    def per_hop_cycles(self, clock_hz: float) -> float:
        return self.per_hop_s * clock_hz


def run_chase(working_set_bytes: int, hop_counts: Sequence[int] = (256, 1024,
              4096), seed: int = 0, device=None) -> ChaseResult:
    dev = resolve_device(device)
    n = max(working_set_bytes // 4, 16)
    arr = torch.from_numpy(_random_cycle(n, seed)).to(dev)
    hops = [int(h) for h in hop_counts]
    if dev.type == "cuda":
        return _run_chase_card(arr, working_set_bytes, hops, dev)
    times = [time_fn(pointer_chase_plain, arr, 0, h, iters=20) for h in hops]
    a, b = fit_latency(hops, times)
    return ChaseResult(working_set_bytes=working_set_bytes, hops=hops,
                       times_s=times, overhead_s=max(a, 0.0),
                       per_hop_s=max(b, 0.0))


def _run_chase_card(arr, working_set_bytes, hops, dev):
    warm = working_set_bytes <= WARM_MAX_BYTES
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    flush = scratch.zero_

    def launch(h, timing):
        ops.pointer_chase(arr, 0, hops=h, space="global", cache_op=CACHE_OP,
                          warm=warm, timing=timing)

    times, cycles, all_cyc, all_ns = [], [], [], []
    for h in hops:
        t, cyc, ns = time_kernel(lambda tm: launch(h, tm), 20, device=dev,
                                 before=flush)
        times.append(t)
        cycles.append(float(np.median(cyc)))
        all_cyc += cyc
        all_ns += ns
    a, _ = fit_latency(hops, times)
    per_cyc = steady_slope(hops, cycles)
    hz = clock_hz(launch, hops[-1], per_cyc, all_cyc, all_ns, cap=1 << 16,
                  device=dev, before=flush)
    return ChaseResult(working_set_bytes=working_set_bytes, hops=hops,
                       times_s=times, overhead_s=max(a, 0.0),
                       per_hop_s=per_cyc / hz, cycles=cycles,
                       cycles_per_hop=per_cyc, clock_hz=hz)


def hierarchy_sweep(sizes=(16 * 2**10, 256 * 2**10, 4 * 2**20, 64 * 2**20),
                    device=None) -> List[ChaseResult]:
    return [run_chase(s, device=device) for s in sizes]


def streaming_bandwidth(size_bytes: int = 64 * 2**20, device=None) -> float:
    """Sequential-read bandwidth (the contrast to the chase's latency): a
    plain ``torch.sum``, as the reference's is a plain ``jnp.sum``."""
    dev = resolve_device(device)
    n = size_bytes // 4
    x = torch.arange(n, dtype=torch.float32, device=dev)
    t = time_fn(torch.sum, x, iters=20, device=dev)
    return size_bytes / t
