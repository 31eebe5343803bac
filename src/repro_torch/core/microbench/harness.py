"""Measurement harness reproducing the paper's methodology on the port.

Paper methodology (section IV-A) -> here, as in ``repro``'s harness:
  * clock reads around an instruction sequence;
  * >=3 instructions to amortize launch overhead (Table I) -> chain length K
    is swept and CPI(K) reported;
  * clock overhead subtraction -> linear regression t(K) = a + bK;
  * dependent vs independent sequences (Table II).

Where the clock is read depends on the device:

* on the card, ``run_chain`` drives the ``alu_chain`` kernel on one (8,128)
  tile.  One chain is a few hundred ns under a launch of several us, so the
  per-op latency comes from the regression of the kernel's own ``clock64()``
  cycles over K (the paper's clock-overhead subtraction), divided by the SM
  clock that the same kernel measured (cycles over ``%globaltimer`` ns).
  The intercept ``overhead_s`` (the launch/dispatch overhead) comes from the
  regression of CUDA-event times, as the reference regresses wall time;
* on the CPU, it times the plain chain (``repro_torch.kernels.ref``) with
  ``perf_counter``, on a (64,512) tile by default, as the reference does.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (ALU_OPS, FLOAT_ONLY, INT_OPS,  # noqa: F401
                                     alu_legal)

# a clock measurement runs at least this many cycles per launch, so the
# globaltimer's granularity is a small part of it
CLOCK_CYCLES = 4e5
CLOCK_LAUNCHES = 5


def time_fn(fn, *args, iters: int = 30, warmup: int = 5,
            device="cpu") -> float:
    """Median time of fn(*args) in seconds: CUDA events around each call on
    a CUDA device (synchronised after each, so a call's dispatch counts),
    ``perf_counter`` on the CPU.

    The timer of the plain versions: the CPU branches of ``run_chain``,
    ``memory.run_chase`` and ``mxu.run_mxu`` call it without a device, so
    its default stays ``"cpu"`` (the probe kernels on the card go through
    ``time_kernel``).  ``memory.streaming_bandwidth`` is its one caller on
    the card, and passes its device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        for _ in range(warmup):
            fn(*args)
        torch.cuda.synchronize(dev)
        ts = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) * 1e-3)
        return float(np.median(ts))
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def time_kernel(launch: Callable, iters: int, warmup: int = 3,
                device="cuda", before: Optional[Callable] = None
                ) -> Tuple[float, List[int], List[int]]:
    """Time ``launch(timing)`` of a probe kernel ``iters`` times: the median
    CUDA-event seconds, and each launch's in-kernel cycles and ns (the
    kernel writes them into its ``timing`` row).  ``before()`` runs ahead
    of each launch, outside the events."""
    dev = torch.device(device)
    rows = torch.zeros((iters, 2), dtype=torch.int64, device=dev)
    for _ in range(warmup):
        launch(None)
    torch.cuda.synchronize(dev)
    ts = []
    for j in range(iters):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        launch(rows[j])
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) * 1e-3)
    cyc, ns = rows.cpu().numpy().T
    return float(np.median(ts)), [int(v) for v in cyc], [int(v) for v in ns]


def fit_latency(lengths: Sequence[int], times: Sequence[float]
                ) -> Tuple[float, float]:
    """Least-squares t = a + b*K -> (overhead a, per-op latency b)."""
    k = np.asarray(lengths, np.float64)
    t = np.asarray(times, np.float64)
    b, a = np.polyfit(k, t, 1)
    return float(a), float(b)


def steady_slope(lengths: Sequence[int], values: Sequence[float]) -> float:
    """The reference's robust per-unit estimate: the regression slope,
    floored by the longest run's overhead-corrected mean."""
    a, b = fit_latency(lengths, values)
    longest = max((values[-1] - max(a, 0.0)) / lengths[-1], 0.0)
    return max(b, longest, 0.0)


def clock_hz(launch: Callable, base_len: int, cycles_per_unit: float,
             cycles: Sequence[int], ns: Sequence[int], cap: int,
             device="cuda", before: Optional[Callable] = None) -> float:
    """The SM clock a probe kernel measured: its cycles over its
    globaltimer ns, pooled over the series' launches and ``CLOCK_LAUNCHES``
    launches of the same kernel at a length of about ``CLOCK_CYCLES``
    cycles (``launch(length, timing)``)."""
    n = min(max(base_len, math.ceil(CLOCK_CYCLES / max(cycles_per_unit, 0.5))),
            cap)
    _, c2, n2 = time_kernel(lambda t: launch(n, t), CLOCK_LAUNCHES,
                            warmup=0, device=device, before=before)
    total_ns = sum(ns) + sum(n2)
    if total_ns <= 0:
        raise RuntimeError("the kernel's globaltimer did not advance")
    return (sum(cycles) + sum(c2)) / total_ns * 1e9


@dataclass
class ChainResult:
    op: str
    dtype: str
    dependent: bool
    lengths: List[int]
    times_s: List[float]
    overhead_s: float
    per_op_s: float
    cpi_curve: Dict[int, float]   # t(K)/(K*t_inf) - the paper's Table I shape
    # on the card: median in-kernel cycles per length, their slope, and the
    # SM clock the kernel measured
    cycles: Optional[List[float]] = None
    cycles_per_op: Optional[float] = None
    clock_hz: Optional[float] = None

    def per_op_cycles(self, clock_hz: float) -> float:
        return self.per_op_s * clock_hz


def _chain_fn(op: Callable, k: int, dependent: bool):
    """k ops of ``op`` over a tile (the plain chain, for the CPU)."""
    if dependent:
        def f(x, c):
            y = x
            for _ in range(k):
                y = op(y, c)
            return y
    else:
        def f(x, c):
            # k independent ops on k slices, combined once at the end
            ys = [op(x + i, c) for i in range(k)]
            out = ys[0]
            for y in ys[1:]:
                out = out + y * 0  # keep all live without a dependency chain
            return out
    return f


def _chain_inputs(dtype, shape, dev):
    n = int(np.prod(shape))
    x = torch.linspace(0.5, 1.5, n, dtype=torch.float32).reshape(shape)
    c = torch.tensor(1.0009765625, dtype=torch.float32)  # keeps chains tame
    return x.to(dtype).to(dev), c.to(dtype).to(dev)


def run_chain(op: Callable, name: str, dtype=torch.float32,
              lengths: Sequence[int] = (4, 16, 64, 256),
              dependent: bool = True, shape=None,
              device=None) -> ChainResult:
    """Per-op latency of ``name`` (whose plain form is ``op``) in ``dtype``
    by chain-length regression.  On the card the ``alu_chain`` kernel runs
    on its (8,128) tile; on the CPU the plain chain runs on ``shape``
    (default (64,512))."""
    dev = resolve_device(device)
    lengths = [int(k) for k in lengths]
    if dev.type == "cuda":
        return _run_chain_card(name, dtype, lengths, dependent, dev)
    x, c = _chain_inputs(dtype, shape or (64, 512), dev)
    times = [time_fn(_chain_fn(op, k, dependent), x, c) for k in lengths]
    a, _ = fit_latency(lengths, times)
    t_inf = max(steady_slope(lengths, times), 1e-12)
    cpi_curve = {k: float(t / (k * t_inf)) for k, t in zip(lengths, times)}
    return ChainResult(op=name, dtype=str(dtype).replace("torch.", ""),
                       dependent=dependent, lengths=lengths, times_s=times,
                       overhead_s=max(a, 0.0),
                       per_op_s=steady_slope(lengths, times),
                       cpi_curve=cpi_curve)


def _run_chain_card(name, dtype, lengths, dependent, dev) -> ChainResult:
    x, c = _chain_inputs(dtype, (8, 128), dev)

    def launch(k, timing):
        ops.alu_chain(x, c, op=name, length=k, dependent=dependent,
                      timing=timing)

    times, cycles, all_cyc, all_ns = [], [], [], []
    for k in lengths:
        t, cyc, ns = time_kernel(lambda tm: launch(k, tm), 30, device=dev)
        times.append(t)
        cycles.append(float(np.median(cyc)))
        all_cyc += cyc
        all_ns += ns
    a, _ = fit_latency(lengths, times)
    per_cyc = steady_slope(lengths, cycles)
    hz = clock_hz(launch, lengths[-1], per_cyc, all_cyc, all_ns,
                  cap=1 << 22, device=dev)
    c_inf = max(per_cyc, 1e-12)
    cpi_curve = {k: float(cy / (k * c_inf)) for k, cy in zip(lengths, cycles)}
    return ChainResult(op=name, dtype=str(dtype).replace("torch.", ""),
                       dependent=dependent, lengths=lengths, times_s=times,
                       overhead_s=max(a, 0.0), per_op_s=per_cyc / hz,
                       cpi_curve=cpi_curve, cycles=cycles,
                       cycles_per_op=per_cyc, clock_hz=hz)


# --- the op registry (the paper's Table V rows, dtype-major) ----------------

OPS: Dict[str, Callable] = ALU_OPS


def default_suite(dtypes=("float32", "bfloat16", "int32"),
                  lengths=(4, 16, 64, 256), device=None) -> List[ChainResult]:
    out = []
    for dt in dtypes:
        tdt = getattr(torch, dt)
        for name, op in OPS.items():
            if not alu_legal(name, tdt):
                continue
            for dep in (True, False):
                out.append(run_chain(op, name, tdt, lengths, dep,
                                     device=device))
    return out
