"""The named-experiment registry: the paper's campaigns the port runs.

The port's copy of ``repro.core.campaign.registry``'s experiments, with
the same grids, quick grids, constraint, costs, tags and cell keys
(Abdelkhalik et al., arXiv:2208.11174):

  * ``alu_chain``            - Tables I/II: per-op latency via chain-length
                               regression, dependent vs independent
  * ``memory_chase``         - Table IV / Fig. 2-3: pointer-chase walk of the
                               memory hierarchy + streaming bandwidth
  * ``mxu_shapes``           - Table III: matrix-unit latency/throughput per
                               dtype x tile shape (the WMMA fragment sweep)
  * ``roofline_calibration`` - achieved peaks (tensor-core TFLOP/s, HBM
                               GB/s, dispatch overhead)
  * ``isa_mapping``          - Table V: PTX -> SASS expansion per op class,
                               counted by ``core.isa.sass_census`` over
                               ``nvcc -ptx`` and ``cuobjdump -sass`` of
                               one source (needs the CUDA toolkit)
  * ``paged_serve``          - slot vs paged KV cache on one trace
  * ``decode_hotpath``       - the legacy blocking decode path
                               (``fused=False``) vs the fused one

Not ported yet: ``autotune``, ``decode_longctx``, ``telemetry_replay``,
``traffic_scaling``, ``sharded_decode``, ``chaos_serving``.

Cell runners take ``(params, quick=..., device=...)`` and return a flat-ish
metrics dict: the reference's metrics, plus on the card the in-kernel
cycles and the SM clock the probe kernel measured, and the serving cells'
peak device memory.  ``device=None`` is the
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


# what ``dispatch_overhead_us`` measures: on the card one ``alu_chain``
# kernel launch, the call's other host work done before the events
DISPATCH_DETAIL = ("launch intercept: a of t(K)=a+bK over dependent add.f32 "
                   "alu_chain chains, K=1..8 (on the card the CUDA-event "
                   "time of one kernel launch, its host side included, the "
                   "call's checks and output made before the events; on "
                   "the CPU the plain chain's perf_counter time)")


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
                "detail": DISPATCH_DETAIL}
    raise ValueError(f"unknown roofline calibration term {term!r}")


def run_isa_cell(params: Dict[str, Any], quick: bool = False,
                 device=None) -> Dict[str, Any]:
    """PTX -> SASS expansion for one op class (Table V): the case's kernel
    in ``core/isa/csrc/isa_cases.cu``, its PTX entry against its SASS
    function.  Compiles and launches nothing on ``device``; fails where
    the CUDA toolkit is missing, naming the missing tool."""
    from repro_torch.core.isa import sass_census

    return sass_census.case_metrics(params["case"],
                                    *sass_census.build_texts())


def _serving_setup(device):
    """The serving cells' model: reduced gemma2-2b (2 layers, vocab 128)
    with weights from seed 0, on ``device``."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.zoo import build_model

    cfg = reduced(ARCHS["gemma2-2b"], n_layers=2, vocab_size=128)
    model = build_model(cfg, device=device)
    return cfg, model, model.init(0)


def _serving_trace(cfg, params, quick):
    """The serving cells' trace: 16 prompts (6 quick) of 1-32 tokens from
    rng 0; the generator is returned for the warm-up prompts after it."""
    import numpy as np

    n_req = 6 if quick else int(params.get("n_requests", 16))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(1, 33))).astype(np.int32)
               for _ in range(n_req)]
    return prompts, rng


def run_paged_serve_cell(params: Dict[str, Any], quick: bool = False,
                         device=None) -> Dict[str, Any]:
    """Serve one deterministic mixed-length trace through BOTH engines and
    compare: tokens/s, resident KV bytes, greedy-token equality, and the
    paged engine's preemption/leak accounting."""
    import time

    from repro_torch.serve.engine import PagedServingEngine, ServingEngine
    device = resolve_device(device)

    cfg, model, weights = _serving_setup(device)
    prompts, _ = _serving_trace(cfg, params, quick)
    max_batch, max_len = 4, 64

    slot = ServingEngine(model, weights, max_batch=max_batch,
                         max_len=max_len)
    rids_s = [slot.submit(p, max_new_tokens=6) for p in prompts]
    t0 = time.perf_counter()
    s_stats = slot.run_until_done()
    slot_s = time.perf_counter() - t0

    bs = int(params["block_size"])
    pool = params.get("n_blocks")
    # default pool: ~60% of the slot-equivalent rectangle
    n_blocks = int(pool) if pool else max(
        -(-max_len // bs), int(0.6 * max_batch * (-(-max_len // bs))))
    paged = PagedServingEngine(model, weights, max_batch=max_batch,
                               max_len=max_len, block_size=bs,
                               n_blocks=n_blocks,
                               chunk_size=int(params.get("chunk", 16)))
    rids_p = [paged.submit(p, max_new_tokens=6) for p in prompts]
    t0 = time.perf_counter()
    p_stats = paged.run_until_done(max_steps=20_000)
    paged_s = time.perf_counter() - t0

    identical = all(slot.done[a].tokens == paged.done[b].tokens
                    for a, b in zip(rids_s, rids_p))
    paged.allocator.check()
    return {
        "completed_slot": s_stats.completed,
        "completed_paged": p_stats.completed,
        "slot_tok_per_s": s_stats.decoded_tokens / max(slot_s, 1e-9),
        "paged_tok_per_s": p_stats.decoded_tokens / max(paged_s, 1e-9),
        "slot_kv_bytes": slot.kv_cache_bytes(),
        "paged_kv_bytes": paged.kv_cache_bytes(),
        "kv_bytes_ratio": paged.kv_cache_bytes() / slot.kv_cache_bytes(),
        "identical_tokens": identical,
        "preemptions": p_stats.preemptions,
        "prefill_chunks": p_stats.prefill_chunks,
        "peak_block_occupancy": p_stats.peak_blocks_in_use / n_blocks,
        "blocks_leaked": n_blocks - paged.allocator.n_free,
    }


def run_decode_hotpath_cell(params: Dict[str, Any], quick: bool = False,
                            device=None) -> Dict[str, Any]:
    """Serve one deterministic trace through an engine's legacy blocking
    path (``fused=False``: fresh uploads, [B, vocab] logits synced, the
    step written into a copy of the store) and through the fused hot path
    (on-device sampling, in-place store, pipelined steps) and compare:
    tokens/s, host syncs per step, resident KV bytes, greedy-token
    equality, the analytic cost model's predicted per-step byte savings
    and, on the card, each timed region's peak device memory
    (``<label>_peak_bytes``: the legacy path holds two stores)."""
    import time

    import numpy as np

    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.costmodel import analytic
    from repro_torch.serve.engine import PagedServingEngine, ServingEngine
    device = resolve_device(device)

    cfg, model, weights = _serving_setup(device)
    prompts, rng = _serving_trace(cfg, params, quick)
    max_batch, max_len = 4, 64

    def build(fused):
        if params["engine"] == "paged":
            return PagedServingEngine(model, weights, max_batch=max_batch,
                                      max_len=max_len, block_size=8,
                                      chunk_size=16, fused=fused)
        return ServingEngine(model, weights, max_batch=max_batch,
                             max_len=max_len, fused=fused)

    out: Dict[str, Any] = {"engine": params["engine"]}
    done = {}
    warmup = [rng.integers(0, cfg.vocab_size, size=5).astype(np.int32)
              for _ in range(2)]
    for label, fused in (("baseline", False), ("fused", True)):
        eng = build(fused)
        # warm the engine first, so the timed region holds steady-state
        # decode, not first-call costs (kernel loads, allocator growth)
        for p in warmup:
            eng.submit(p, max_new_tokens=4)
        eng.run_until_done(max_steps=20_000)
        steps0, dec0 = eng.stats.steps, eng.stats.decoded_tokens
        syncs0 = eng.stats.host_syncs
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        t0 = time.perf_counter()
        stats = eng.run_until_done(max_steps=20_000)
        wall = time.perf_counter() - t0
        done[label] = [eng.done[r].tokens for r in rids]
        steps = stats.steps - steps0
        out[f"{label}_tok_per_s"] = ((stats.decoded_tokens - dec0)
                                     / max(wall, 1e-9))
        out[f"{label}_steps"] = steps
        out[f"{label}_syncs_per_step"] = ((stats.host_syncs - syncs0)
                                          / max(steps, 1))
        out[f"{label}_kv_bytes"] = eng.kv_cache_bytes()
        if device.type == "cuda":
            out[f"{label}_peak_bytes"] = torch.cuda.max_memory_allocated(
                device)
        del eng
    out["identical_tokens"] = done["baseline"] == done["fused"]
    out["speedup"] = out["fused_tok_per_s"] / max(out["baseline_tok_per_s"],
                                                  1e-9)
    # the cost model's view of what the fused path removed per step
    cell = ShapeCell("hotpath", "decode", max_len, max_batch)
    legacy_b = analytic.analytic_serve_bytes(cfg, cell, 1, n_model=1)
    fused_b = analytic.analytic_serve_bytes(cfg, cell, 1, n_model=1,
                                            donated=True)
    out["predicted_hbm_bytes_saved"] = legacy_b - fused_b
    out["predicted_boundary_bytes_saved"] = (
        analytic.decode_boundary_bytes(cfg, cell)
        - analytic.decode_boundary_bytes(cfg, cell, device_sampling=True))
    return out


ISA_CASES = ("add.f32", "mul.f32", "fma.f32", "div.f32", "rsqrt.f32",
             "exp.f32", "tanh.f32", "softmax.f32", "matmul.f32",
             "reduce.f32", "gather", "scan8")

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

register(Experiment(
    name="paged_serve",
    description="slot vs paged KV-cache serving on one deterministic "
                "mixed-length trace: tokens/s, resident KV bytes, greedy "
                "equality, preemption + block-leak accounting",
    grid={"block_size": (8, 16), "chunk": (16,)},
    quick_grid={"block_size": (8,), "chunk": (8,)},
    runner=run_paged_serve_cell,
    cost_per_cell_s=30.0,
    tags=("serve", "paging", "memory"),
))

register(Experiment(
    name="decode_hotpath",
    description="legacy blocking decode vs the fused hot path (on-device "
                "sampling, donated caches, pipelined steps) on one trace: "
                "tok/s, host syncs/step, KV bytes, greedy equality",
    grid={"engine": ("slot", "paged")},
    runner=run_decode_hotpath_cell,
    cost_per_cell_s=30.0,
    tags=("serve", "hotpath", "memory"),
))

register(Experiment(
    name="isa_mapping",
    description="source -> optimized instruction expansion per op class "
                "(paper Table V, the PTX->SASS map)",
    grid={"case": ISA_CASES},
    quick_grid={"case": ("add.f32", "softmax.f32", "matmul.f32", "scan8")},
    runner=run_isa_cell,
    cost_per_cell_s=0.5,
    tags=("isa",),
))
