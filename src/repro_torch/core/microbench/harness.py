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
  The intercept ``overhead_s`` comes from the regression of CUDA-event
  times, as the reference regresses wall time: the events hold one
  kernel launch and nothing else (the call's checks, c's bits and its
  output are done before them, ``alu_chain.prepare``), so it is the
  launch's cost, its host side included;
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
from repro_torch.kernels import alu_chain
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


def cold_copies(args: Sequence, device="cuda", limit: int = 20
                ) -> List[tuple]:
    """``args`` and clones of its tensors, enough sets that together they
    hold at least twice the card's L2 (read from the device), so that a
    timer cycling over them (``device_time``) finds no call's inputs in
    the L2, as a serving step finds each layer's KV pool; at most
    ``limit`` sets (inputs of a few MB stay partly warm).  On the CPU
    ``[args]``."""
    dev = torch.device(device)
    args = tuple(args)
    if dev.type != "cuda":
        return [args]
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    n = min(limit, max(1, math.ceil(2 * l2 / max(nbytes, 1))))
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(n - 1)]


def device_time(calls, iters: int = 20, warmup: int = 1,
                device="cuda") -> float:
    """Seconds of one call on the device, host cost left out.  ``calls``
    is a callable or a list of them, each on its own copy of the inputs
    (``cold_copies``): on a CUDA device ``iters`` calls, call i running
    ``calls[i % len(calls)]``, captured in one CUDA graph (after
    ``warmup`` rounds of every call on a side stream, as capture
    requires), the graph replayed between one CUDA event pair, over
    ``iters``; the median of 5 replays.  A call that reads a device
    value on the host cannot be captured and raises.  On the CPU it is
    ``time_fn`` of the first call.

    The timer of the autotuner's measured stage, of ``decode_longctx`` and
    of ``chip_smoke.py``'s kernel phase: their kernels run for
    microseconds under tens of microseconds of launch cost, which
    ``time_fn`` on the card counts."""
    calls = list(calls) if isinstance(calls, (list, tuple)) else [calls]
    dev = torch.device(device)
    if dev.type != "cuda":
        return time_fn(calls[0], iters=iters, warmup=warmup, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(max(warmup, 1)):
            for fn in calls:
                fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize(dev)
    ts = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) * 1e-3 / iters)
    del graph
    return float(np.median(ts))


def time_kernels(launches: Sequence[Callable], iters: int, warmup: int = 3,
                 device="cuda", before: Optional[Callable] = None,
                 staged: bool = False
                 ) -> List[Tuple[float, List[int], List[int]]]:
    """Time ``launch(timing)`` of a probe kernel ``iters`` times for each of
    ``launches``, in turns (one of each, then again), so that the host's
    drift falls on each alike: for each, the median CUDA-event seconds and
    each launch's in-kernel cycles and ns (the kernel writes them into its
    ``timing`` row).  Where there are several, an untimed launch of the
    same one runs just ahead of each timed launch, so that its code is in
    the SM's instruction cache as it would be in a run of that launch
    alone.  ``before()`` runs ahead of each launch, outside the events, as
    does taking the launch's row.  With ``staged``, ``launch(timing)`` does
    the call's work up to its kernel launch and returns that launch, which
    alone runs between the events."""
    dev = torch.device(device)
    rows = torch.zeros((len(launches), iters, 2), dtype=torch.int64,
                       device=dev)

    def untimed(launch):
        go = launch(None)
        if staged:
            go()

    for launch in launches:
        for _ in range(warmup):
            untimed(launch)
    torch.cuda.synchronize(dev)
    ts = [[] for _ in launches]
    for j in range(iters):
        for i, launch in enumerate(launches):
            if len(launches) > 1:
                untimed(launch)
                torch.cuda.synchronize(dev)
            row = rows[i, j]
            if before is not None:
                before()
            go = launch(row) if staged else (lambda: launch(row))
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            go()
            b.record()
            b.synchronize()
            ts[i].append(a.elapsed_time(b) * 1e-3)
    data = rows.cpu().numpy()
    return [(float(np.median(t)), [int(v) for v in data[i, :, 0]],
             [int(v) for v in data[i, :, 1]]) for i, t in enumerate(ts)]


def time_kernel(launch: Callable, iters: int, warmup: int = 3,
                device="cuda", before: Optional[Callable] = None,
                staged: bool = False) -> Tuple[float, List[int], List[int]]:
    """``time_kernels`` of one launch."""
    return time_kernels([launch], iters, warmup, device, before, staged)[0]


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
             device="cuda", before: Optional[Callable] = None,
             staged: bool = False) -> float:
    """The SM clock a probe kernel measured: its cycles over its
    globaltimer ns, pooled over the series' launches and ``CLOCK_LAUNCHES``
    launches of the same kernel at a length of about ``CLOCK_CYCLES``
    cycles (``launch(length, timing)``)."""
    n = min(max(base_len, math.ceil(CLOCK_CYCLES / max(cycles_per_unit, 0.5))),
            cap)
    _, c2, n2 = time_kernel(lambda t: launch(n, t), CLOCK_LAUNCHES,
                            warmup=0, device=device, before=before,
                            staged=staged)
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

    def launch(k, timing):          # the call's work; its launch is timed
        return alu_chain.prepare(x, c, op=name, length=k,
                                 dependent=dependent, timing=timing)[0]

    times, cycles, all_cyc, all_ns = [], [], [], []
    for t, cyc, ns in time_kernels(
            [lambda tm, k=k: launch(k, tm) for k in lengths], 30, device=dev,
            staged=True):
        times.append(t)
        cycles.append(float(np.median(cyc)))
        all_cyc += cyc
        all_ns += ns
    a, _ = fit_latency(lengths, times)
    per_cyc = steady_slope(lengths, cycles)
    hz = clock_hz(launch, lengths[-1], per_cyc, all_cyc, all_ns,
                  cap=1 << 22, device=dev, staged=True)
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
