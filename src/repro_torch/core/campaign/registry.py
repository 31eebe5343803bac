"""The named-experiment registry: the paper's four calibration campaigns.

The port's copy of ``repro.core.campaign.registry``'s calibration
experiments, with the same grids, quick grids, constraint and cell keys
(Abdelkhalik et al., arXiv:2208.11174):

  * ``alu_chain``            - Tables I/II: per-op latency via chain-length
                               regression, dependent vs independent
  * ``memory_chase``         - Table IV / Fig. 2-3: pointer-chase walk of the
                               memory hierarchy + streaming bandwidth
  * ``mxu_shapes``           - Table III: matrix-unit latency/throughput per
                               dtype x tile shape (the WMMA fragment sweep)
  * ``roofline_calibration`` - achieved peaks (tensor-core TFLOP/s, HBM
                               GB/s, dispatch overhead)

Cell runners take ``(params, quick=..., device=...)`` and return a flat-ish
metrics dict: the reference's metrics, plus on the card the in-kernel
cycles and the SM clock the probe kernel measured.  ``device=None`` is the
card (``resolve_device``), as at every entry point of the port.  The scheduler in
``runner.py`` owns ordering, persistence and resume.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch import resolve_device
from repro_torch.core.campaign.spec import Experiment
from repro_torch.kernels.ref import ALU_OPS, alu_legal


def run_alu_cell(params: Dict[str, Any], quick: bool = False,
                 device=None) -> Dict[str, Any]:
    from repro_torch.core.microbench import harness
    device = resolve_device(device)

    lengths = (4, 16, 64) if quick else (4, 16, 64, 256)
    r = harness.run_chain(harness.OPS[params["op"]], params["op"],
                          dtype=getattr(torch, params["dtype"]),
                          lengths=lengths, dependent=params["dependent"],
                          device=device)
    out = {
        "per_op_ns": r.per_op_s * 1e9,
        "overhead_ns": r.overhead_s * 1e9,
        "lengths": list(r.lengths),
        "times_us": [t * 1e6 for t in r.times_s],
        "cpi_curve": {str(k): v for k, v in r.cpi_curve.items()},
    }
    if r.cycles is not None:
        out.update(cycles=r.cycles, per_op_cycles=r.cycles_per_op,
                   clock_hz=r.clock_hz)
    return out


def run_chase_cell(params: Dict[str, Any], quick: bool = False,
                   device=None) -> Dict[str, Any]:
    from repro_torch.core.microbench import memory
    device = resolve_device(device)

    size_bytes = params["size_kib"] * 1024
    if params.get("access", "chase") == "stream":
        bw = memory.streaming_bandwidth(size_bytes, device=device)
        return {"gbps": bw / 1e9, "working_set_bytes": size_bytes}
    hops = (64, 256, 1024) if quick else (256, 1024, 4096)
    r = memory.run_chase(size_bytes, hop_counts=hops, device=device)
    out = {
        "per_hop_ns": r.per_hop_s * 1e9,
        "overhead_ns": r.overhead_s * 1e9,
        "working_set_bytes": r.working_set_bytes,
        "hops": list(r.hops),
        "times_us": [t * 1e6 for t in r.times_s],
    }
    if r.cycles is not None:
        out.update(cache_op=memory.CACHE_OP, cycles=r.cycles,
                   per_hop_cycles=r.cycles_per_hop, clock_hz=r.clock_hz)
    return out


def run_mxu_cell(params: Dict[str, Any], quick: bool = False,
                 device=None) -> Dict[str, Any]:
    from repro_torch.core.microbench import mxu
    device = resolve_device(device)

    lengths = (1, 2, 4) if quick else (1, 2, 4, 8)
    # no s8 product in the probe: int8 cells measure the bf16 path and
    # record the substitution, as the reference does
    dtype = params["dtype"]
    compute_dtype = "bfloat16" if dtype == "int8" else dtype
    r = mxu.run_mxu(dtype=compute_dtype, shape=tuple(params["shape"]),
                    dependent=params["dependent"], lengths=lengths,
                    device=device)
    out = {
        "per_op_us": r.per_op_s * 1e6,
        "overhead_us": r.overhead_s * 1e6,
        "flops": r.flops,
        "tflops": r.tflops,
        "compute_dtype": compute_dtype,
    }
    if r.block is not None:
        out["block"] = list(r.block)
    if r.reps is not None:
        out["reps"] = r.reps
    if r.cycles is not None:
        out.update(cycles=r.cycles, per_op_cycles=r.cycles_per_op,
                   clock_hz=r.clock_hz)
    return out


def run_roofline_cal_cell(params: Dict[str, Any], quick: bool = False,
                          device=None) -> Dict[str, Any]:
    """Measure one achieved-peak term of the roofline on this device."""
    device = resolve_device(device)
    term = params["term"]
    if term == "mxu_peak_tflops":
        from repro_torch.core.microbench import mxu
        shape = (256, 256, 256) if quick else (512, 512, 512)
        r = mxu.run_mxu(dtype="float32", shape=shape, dependent=False,
                        lengths=(1, 2, 4), device=device)
        return {"value": r.tflops, "unit": "TFLOP/s",
                "detail": f"independent f32 matmul {shape}, {r.reps} "
                          "products a unit"}
    if term == "hbm_stream_gbs":
        from repro_torch.core.microbench import memory
        size = 16 * 2**20 if quick else 64 * 2**20
        bw = memory.streaming_bandwidth(size, device=device)
        return {"value": bw / 1e9, "unit": "GB/s",
                "detail": f"sequential reduce over {size // 2**20} MiB"}
    if term == "dispatch_overhead_us":
        from repro_torch.core.microbench import harness
        r = harness.run_chain(harness.OPS["add"], "add", dtype=torch.float32,
                              lengths=(1, 2, 4, 8), dependent=True,
                              device=device)
        return {"value": r.overhead_s * 1e6, "unit": "us",
                "detail": "t(K)=a+bK regression intercept, add.f32"}
    raise ValueError(f"unknown roofline calibration term {term!r}")


_ALU_OPS = tuple(ALU_OPS)


def _alu_legal(params: Dict[str, Any]) -> bool:
    return alu_legal(params["op"], getattr(torch, params["dtype"]))


REGISTRY: Dict[str, Experiment] = {}


def register(exp: Experiment) -> Experiment:
    if exp.name in REGISTRY:
        raise ValueError(f"experiment {exp.name!r} already registered")
    REGISTRY[exp.name] = exp
    return exp


def get(name: str) -> Experiment:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown experiment {name!r}; available: "
                       f"{', '.join(names())}") from None


def names() -> List[str]:
    return sorted(REGISTRY)


register(Experiment(
    name="alu_chain",
    description="per-op latency via chain-length regression, dependent vs "
                "independent (paper Tables I/II)",
    grid={"op": _ALU_OPS,
          "dtype": ("float32", "bfloat16", "int32"),
          "dependent": (True, False)},
    quick_grid={"op": ("add", "mul", "fma", "exp"),
                "dtype": ("float32",),
                "dependent": (True, False)},
    constraint=_alu_legal,
    runner=run_alu_cell,
    cost_per_cell_s=2.0,
    tags=("vpu", "latency"),
))

register(Experiment(
    name="memory_chase",
    description="memory-hierarchy pointer chase + streaming bandwidth over "
                "working-set sizes (paper Table IV / Fig. 2-3)",
    grid={"access": ("chase", "stream"),
          "size_kib": (16, 256, 4096, 65536)},
    quick_grid={"access": ("chase", "stream"),
                "size_kib": (16, 4096)},
    runner=run_chase_cell,
    cost_per_cell_s=3.0,
    tags=("memory", "latency"),
))

register(Experiment(
    name="mxu_shapes",
    description="matrix-unit latency/throughput per dtype x tile shape "
                "(paper Table III, the WMMA fragment sweep; int8 measures "
                "the bf16 path where no s8 dot exists)",
    grid={"dtype": ("bfloat16", "float32", "int8"),
          "shape": ((128, 128, 128), (256, 256, 256), (512, 512, 128)),
          "dependent": (True, False)},
    quick_grid={"dtype": ("float32",),
                "shape": ((128, 128, 128),),
                "dependent": (True, False)},
    runner=run_mxu_cell,
    cost_per_cell_s=4.0,
    tags=("mxu", "throughput"),
))

register(Experiment(
    name="roofline_calibration",
    description="achieved peaks (MXU TFLOP/s, HBM GB/s, dispatch overhead) "
                "that anchor the roofline/predictor calibration",
    grid={"term": ("mxu_peak_tflops", "hbm_stream_gbs",
                   "dispatch_overhead_us")},
    runner=run_roofline_cal_cell,
    cost_per_cell_s=5.0,
    tags=("roofline", "calibration"),
))
