"""Matrix-unit probes (the paper's section IV-C tensor-core WMMA study).

Per (dtype x shape), the latency and throughput of a tile matmul.  A
dependent chain (C <- A@C) measures LATENCY; independent products measure
THROUGHPUT, the same dependent/independent split the paper applies to
scalar instructions.  Both go through the port's ``mxu_probe``: on the card
the WMMA kernel (bf16 m16n16k16, f32 as tf32 m16n16k8), on the CPU its
plain version.

* dependent: ``mxu_probe(a, c, chain=L)`` with one block per ``[K, bn]``
  column panel (``bm == M``, which the chain needs square); on the card the
  per-op latency is the slope of the kernel's ``clock64()`` cycles over L,
  divided by the SM clock it measured;
* independent: L products ``a @ c_i`` as one ``mxu_probe(a, [c_0 | ... |
  c_{L-1}], chain=1)`` over a grid of independent tiles; the per-op time is
  the slope of CUDA-event (card) or ``perf_counter`` (CPU) times over L, as
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
from repro_torch.kernels.mxu_probe import SMEM_MAX

# shared memory of the kernel's 8 bf16 staging fragments (mxu_probe.cu)
_STAGE_BYTES = 8 * 256 * 4


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


def dependent_block(m, n, k, dtype, chain) -> Tuple[int, int]:
    """(m, bn) for a dependent chain: the widest column panel of 128, 64,
    32 or 16 that divides n and whose double buffer fits a block's shared
    memory (the whole n when nothing divides)."""
    elem = torch.empty((), dtype=dtype).element_size()
    nbuf = 0 if chain <= 1 else (1 if chain == 2 else 2)
    for bn in (128, 64, 32, 16):
        if n % bn == 0 and nbuf * k * bn * elem + _STAGE_BYTES <= SMEM_MAX:
            return m, bn
    return m, n


def run_mxu(dtype="bfloat16", shape=(128, 128, 128), dependent=True,
            lengths: Sequence[int] = (1, 2, 4, 8), device=None) -> MXUResult:
    dev = resolve_device(device)
    m, n, k = shape
    dt = getattr(torch, dtype)
    a = (torch.ones((m, k), dtype=torch.float32, device=dev) * 0.01).to(dt)
    lengths = [int(L) for L in lengths]
    times, cycles, all_cyc, all_ns, block = [], [], [], [], None
    for L in lengths:
        if dependent:
            c = (torch.ones((k, n), dtype=torch.float32, device=dev)
                 * 0.01).to(dt)
            block = dependent_block(m, n, k, dt, max(lengths)) \
                if dev.type == "cuda" else (m, n)

            def launch(tm, L=L, c=c, block=block):
                ops.mxu_probe(a, c, chain=L, block=block, timing=tm)
        else:
            cs = (torch.ones((k, L * n), dtype=torch.float32, device=dev)
                  * 0.01).to(dt)
            block = ops.resolve_mxu_block(m, L * n)

            def launch(tm, cs=cs):
                ops.mxu_probe(a, cs, chain=1, timing=tm)
        if dev.type == "cuda":
            t, cyc, ns = time_kernel(launch, 10, device=dev)
            cycles.append(float(np.median(cyc)))
            all_cyc += cyc
            all_ns += ns
        else:
            t = time_fn(launch, None, iters=10)
        times.append(t)
    ov, per = fit_latency(lengths, times)
    flops = 2.0 * m * n * k
    extra = {}
    if dev.type == "cuda":
        extra["block"] = tuple(block)
        if dependent:
            _, per_cyc = fit_latency(lengths, cycles)

            def long_launch(chain, tm):
                ops.mxu_probe(a, c, chain=chain, block=block, timing=tm)

            hz = clock_hz(long_launch, lengths[-1], per_cyc, all_cyc, all_ns,
                          cap=4096, device=dev)
            per = per_cyc / hz
            extra.update(cycles=cycles, cycles_per_op=per_cyc, clock_hz=hz)
    return MXUResult(dtype=dtype, shape=(m, n, k), dependent=dependent,
                     per_op_s=max(per, 1e-12), overhead_s=max(ov, 0.0),
                     flops=flops, tflops=flops / max(per, 1e-12) / 1e12,
                     **extra)


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
