"""Matrix-unit probes (the paper's section IV-C tensor-core WMMA study).

Per (dtype x shape), the latency and throughput of a tile matmul.  A
dependent chain (C <- A@C) measures LATENCY; independent products measure
THROUGHPUT, the same dependent/independent split the paper applies to
scalar instructions.  Both go through the port's ``mxu_probe``: on the card
the tensor-core kernel (``mma.sync``: bf16 m16n8k16, f32 as tf32 m16n8k8),
on the CPU its plain version.

* dependent: ``mxu_probe(a, c, chain=L)`` with one block per ``[K, bn]``
  column panel (``bm == M``, which the chain needs square); on the card the
  per-op latency is the slope of the kernel's ``clock64()`` cycles over L,
  divided by the SM clock it measured;
* independent: the reference launches L products ``a @ c_i`` as one grid
  and regresses wall time over L.  On a TPU that grid runs in order on one
  core, so L products take L times as long.  On the card the blocks run
  side by side on 132 SMs, and 1-8 tiles would leave the card nearly idle
  and the slope near zero.  So on the card one unit of L is one full wave
  of the probe's blocks: ``reps = ceil(SMs * blocks_per_SM /
  tiles_per_product)`` products (``mxu_probe.throughput_reps``, with the
  blocks an SM holds from the CUDA occupancy calculator), launched as one
  ``mxu_probe(a, [c_0 | ... | c_{L*reps-1}], chain=1)``.  The per-op time
  is the slope of CUDA-event times over L divided by ``reps``: one
  product's share of a busy card, the reference's measurement carried to a
  grid that runs in parallel.  Each launch is queued behind a device-side
  sleep, so the events time the device's work and not the host's call.
  On the CPU ``reps`` is 1 and ``perf_counter`` times the plain version, as
  the reference regresses wall time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.microbench.harness import (clock_hz, fit_latency,
                                                 time_fn, time_kernel)
from repro_torch.kernels import ops
from repro_torch.kernels.mxu_probe import (SMEM_MAX, blocks_per_sm,
                                           smem_bytes, throughput_reps)

# the H100 SXM's dense tensor-core peaks (NVIDIA's data sheet, 700 W), by
# the cell's dtype: int8 cells measure the bf16 path; f32 runs as tf32
DENSE_PEAK_TFLOPS = {"bfloat16": 989.0, "int8": 989.0, "float32": 495.0}
# the floor ``run_mxu`` clamps a per-op time to: a reading there is no
# measurement
PER_OP_FLOOR_S = 1e-12
# cycles of the device-side sleep queued ahead of each timed launch (about
# 100 us at 2 GHz, longer than the host's call)
_SLEEP_CYCLES = 200_000


@dataclass
class MXUResult:
    dtype: str
    shape: Tuple[int, int, int]          # (m, n, k)
    dependent: bool
    per_op_s: float
    overhead_s: float
    flops: float
    tflops: float
    # on the card: the launch's block, and for a dependent chain the median
    # in-kernel cycles per length, their slope and the SM clock measured
    block: Optional[Tuple[int, int]] = None
    cycles: Optional[List[float]] = None
    cycles_per_op: Optional[float] = None
    clock_hz: Optional[float] = None
    # independent: the products in one unit of L (1 on the CPU)
    reps: Optional[int] = None


def dependent_block(m, n, k, dtype, chain) -> Tuple[int, int]:
    """(m, bn) for a dependent chain: the widest column panel of 128, 64,
    32 or 16 that divides n and that the kernel can run within a block's
    shared memory (``mxu_probe.smem_bytes``; the whole n when nothing
    divides)."""
    for bn in (128, 64, 32, 16):
        if n % bn == 0 and smem_bytes(dtype, k, m, bn, chain) <= SMEM_MAX:
            return m, bn
    return m, n


def card_reps(m, n, k, dtype, block, device) -> int:
    """Products of shape (m, n, k) in one full wave of (bm, bn) blocks on
    ``device``: ``throughput_reps`` over its SMs and the blocks an SM
    holds."""
    bm, bn = block
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return throughput_reps(sms, blocks_per_sm(dtype, k, bm, bn, 1),
                           (m // bm) * (n // bn))


def run_mxu(dtype="bfloat16", shape=(128, 128, 128), dependent=True,
            lengths: Sequence[int] = (1, 2, 4, 8), device=None) -> MXUResult:
    dev = resolve_device(device)
    card = dev.type == "cuda"
    m, n, k = shape
    dt = getattr(torch, dtype)
    a = (torch.ones((m, k), dtype=torch.float32, device=dev) * 0.01).to(dt)
    lengths = [int(L) for L in lengths]
    times, cycles, all_cyc, all_ns, block = [], [], [], [], None
    reps = None
    if not dependent:
        block = ops.resolve_mxu_block(m, n)
        reps = card_reps(m, n, k, dt, block, dev) if card else 1
    for L in lengths:
        if dependent:
            c = (torch.ones((k, n), dtype=torch.float32, device=dev)
                 * 0.01).to(dt)
            block = dependent_block(m, n, k, dt, max(lengths)) \
                if card else (m, n)

            def launch(tm, L=L, c=c, block=block):
                ops.mxu_probe(a, c, chain=L, block=block, timing=tm)
        else:
            cs = (torch.ones((k, L * reps * n), dtype=torch.float32,
                             device=dev) * 0.01).to(dt)

            def launch(tm, cs=cs):
                ops.mxu_probe(a, cs, chain=1, block=block, timing=tm)
        if card:
            # the independent launch waits behind a device sleep, so its
            # events hold the device's time alone
            before = None if dependent else (
                lambda: torch.cuda._sleep(_SLEEP_CYCLES))
            t, cyc, ns = time_kernel(launch, 10, device=dev, before=before)
            cycles.append(float(np.median(cyc)))
            all_cyc += cyc
            all_ns += ns
        else:
            t = time_fn(launch, None, iters=10)
        times.append(t)
    ov, per = fit_latency(lengths, times)
    flops = 2.0 * m * n * k
    extra = {}
    if not dependent:
        per /= reps
        extra["reps"] = reps
    if card:
        extra["block"] = tuple(block)
        if dependent:
            _, per_cyc = fit_latency(lengths, cycles)

            def long_launch(chain, tm):
                ops.mxu_probe(a, c, chain=chain, block=block, timing=tm)

            hz = clock_hz(long_launch, lengths[-1], per_cyc, all_cyc, all_ns,
                          cap=4096, device=dev)
            per = per_cyc / hz
            extra.update(cycles=cycles, cycles_per_op=per_cyc, clock_hz=hz)
    per = max(per, PER_OP_FLOOR_S)
    return MXUResult(dtype=dtype, shape=(m, n, k), dependent=dependent,
                     per_op_s=per, overhead_s=max(ov, 0.0),
                     flops=flops, tflops=flops / per / 1e12, **extra)


def shape_sweep(dtypes=("bfloat16", "float32"),
                shapes=((128, 128, 128), (256, 256, 256), (512, 512, 512),
                        (128, 128, 512), (512, 512, 128)),
                device=None) -> List[MXUResult]:
    out = []
    for dt in dtypes:
        for s in shapes:
            for dep in (True, False):
                out.append(run_mxu(dt, s, dep, device=device))
    return out
