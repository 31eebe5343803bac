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
  * ``autotune``             - the tables applied: cost-model-guided launch
                               configs per tunable kernel over the card's
                               launch space (predicted best vs default,
                               the measured mode timed on the device)
  * ``paged_serve``          - slot vs paged KV cache on one trace
  * ``decode_hotpath``       - the legacy blocking decode path
                               (``fused=False``) vs the fused one
  * ``decode_longctx``       - long-context decode attention over the paged
                               kernel's token chunk (the card's counterpart
                               of the reference's split-KV sweep)
  * ``telemetry_replay``     - the drift and overload scenarios of the
                               telemetry layer on the sim harness
  * ``traffic_scaling``      - the serving cluster under offered load:
                               round-robin vs cost-aware placement
  * ``chaos_serving``        - fault drills on the serving cluster (sim)

Not ported yet: ``sharded_decode`` (it needs sharding over
``torch.distributed``).

Cell runners take ``(params, quick=..., device=...)`` and return a flat-ish
metrics dict: the reference's metrics, plus on the card the in-kernel
cycles and the SM clock the probe kernel measured, and the serving cells'
peak device memory.  ``device=None`` is the
card (``resolve_device``), as at every entry point of the port.  The scheduler in
``runner.py`` owns ordering, persistence and resume.
"""
from __future__ import annotations

import functools
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


# the autotune cells' problems in quick and measured mode (the
# reference's): small enough for a CPU run of the plain versions
AUTOTUNE_SMALL_SHAPES = {
    "flash_attention": {"batch": 1, "seq_q": 128, "seq_kv": 128,
                        "heads": 2, "kv_heads": 1, "head_dim": 64},
    "paged_attention": {"batch": 2, "heads": 2, "kv_heads": 1,
                        "head_dim": 32, "ctx": 128},
    "ssm_scan": {"batch": 1, "seq": 64, "d_inner": 256, "state_dim": 8},
    "wkv6": {"batch": 1, "seq": 64, "heads": 4, "head_dim": 32},
    "mxu_probe": {"m": 256, "k": 256, "n": 256},
}


def run_autotune_cell(params: Dict[str, Any], quick: bool = False,
                      device=None) -> Dict[str, Any]:
    """Tune one kernel's launch space: analytic ranking always (the cost
    model alone, no device), the measured top-K when mode='measured',
    timed on ``device`` (the card by default; on the CPU the plain
    versions)."""
    from repro_torch.core.autotune import Autotuner
    from repro_torch.core.costmodel import CostModel

    measured = params.get("mode", "analytic") == "measured"
    tuner = Autotuner(CostModel.from_named(params.get("calibration",
                                                      "hopper_h100")),
                      measure=measured, top_k=2 if quick else 3,
                      device=device)
    shapes = None
    if quick or measured:
        shapes = AUTOTUNE_SMALL_SHAPES[params["kernel"]]
    res = tuner.tune(params["kernel"], shapes, dtype=params["dtype"])
    out = {
        "best_config": dict(res.best),
        "default_config": dict(res.default),
        "predicted_best_s": res.predicted_best_s,
        "predicted_default_s": res.predicted_default_s,
        "predicted_speedup": res.predicted_speedup,
        "n_candidates": len(res.ranked),
        "cache_key": res.key,
    }
    if res.measured_best_s is not None:
        out["measured_best_s"] = res.measured_best_s
        if res.measured_speedup is not None:
            out["measured_speedup"] = res.measured_speedup
    return out


# the decode_longctx layout (the reference's): one long sequence, 4 query
# heads over 2 KV heads of 128, 32-token pages in a permuted table
LONGCTX_LAYOUT = dict(B=1, H=4, KH=2, D=128, bs=32)


def longctx_inputs(ctx: int, device, pool_dtype):
    """The decode_longctx cell's inputs from numpy's generator at seed 0,
    drawn in the reference's order: q [B,H,D] f32, the K and V pools
    [P,bs,KH,D] in ``pool_dtype``, a permuted table [B,NB], the context
    lengths and a fixed random readout [H*D, 256] f32."""
    import numpy as np

    L = LONGCTX_LAYOUT
    B, H, KH, D, bs = L["B"], L["H"], L["KH"], L["D"], L["bs"]
    nb = -(-ctx // bs)
    rng = np.random.default_rng(0)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=device, dtype=dt)

    q = t(rng.normal(size=(B, H, D)) * 0.3)
    k_pages = t(rng.normal(size=(B * nb, bs, KH, D)) * 0.3, pool_dtype)
    v_pages = t(rng.normal(size=(B * nb, bs, KH, D)) * 0.3, pool_dtype)
    bt = torch.from_numpy(rng.permutation(B * nb).reshape(B, nb)
                          .astype(np.int32)).to(device)
    lens = torch.full((B,), ctx, dtype=torch.int32, device=device)
    readout = t(rng.normal(size=(H * D, 256)))
    return q, k_pages, v_pages, bt, lens, readout


def run_telemetry_replay_cell(params: Dict[str, Any], quick: bool = False,
                              device=None) -> Dict[str, Any]:
    """Replay one telemetry acceptance scenario on the deterministic sim
    harness (``repro_torch.serve.sim``), the fake model's tensors on
    ``device``, and record its evidence dict: the drift scenario must show
    exactly one recalibration restoring the windowed prediction error
    under the 10% gate; the overload scenario must show the token bucket
    holding the p99 SLO that an ungated run of the same burst violates.
    Both must keep tokens byte-identical."""
    from repro_torch.serve.telemetry.scenarios import (run_drift_scenario,
                                                       run_overload_scenario)
    device = resolve_device(device)

    if params["scenario"] == "drift":
        res = run_drift_scenario(
            drift_factor=float(params.get("factor", 2.0)), device=device)
    else:
        res = run_overload_scenario(load_factor=int(params.get("load", 2)),
                                    device=device)
    # the per-event dicts are nested detail; the flat fields are the table
    res.pop("events", None)
    return res


def run_decode_longctx_cell(params: Dict[str, Any], quick: bool = False,
                            device=None) -> Dict[str, Any]:
    """Long-context decode attention at one token chunk of the paged kernel
    against the default chunk, the cost model's predicted best chunk and
    the plain oracle.

    The reference sweeps its split-KV factor, whose grid cells run in
    sequence under interpret mode, and reports a lane-utilization proxy.
    On the card ``num_splits`` changes no work; the kernel's own grid
    axis is its chunk (``dim3(NC, KH, B)``, ``NC = ceil(NB*bs /
    chunk_tokens)``), so the sweep is over ``chunk_tokens`` and the time is
    the kernels' own: ``harness.device_time``, 20 calls in one CUDA graph
    replayed between CUDA events, cycling over copies of the pools larger
    than the L2 (``harness.cold_copies``), since the call's launch cost
    (tens of microseconds) would bury kernels of a few (on the CPU the
    plain version's ``perf_counter`` time, where the chunk changes
    nothing).  The pools are bf16 on the card (the kernel takes only bf16
    pools) and f32 on the CPU; q stays f32.  The cost model
    (``hopper_h100``) ranks the chunks at this layout from the census's
    grid alone (``predicted_best_chunk``); the analytic tuner ranks the
    whole space (page size too) through the cache-key path, and its
    chunk, timed at this layout's page size, is ``tuned_chunk``.  Greedy
    tokens (argmax through a fixed random readout) at this chunk, at the
    default and from the oracle (``kernels.ref.paged_attention_ref``) must
    agree; ``max_abs_ref`` (max |oracle|) scales ``max_abs_err_vs_ref``."""
    from repro_torch.core.autotune.search import Autotuner
    from repro_torch.core.autotune.space import get_tunable
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.microbench.harness import cold_copies, device_time
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import (CHUNK_TOKENS, CHUNKS,
                                                     chunk_grid)
    from repro_torch.kernels.ref import paged_attention_ref
    device = resolve_device(device)

    ctx, chunk = int(params["ctx"]), int(params["chunk_tokens"])
    L = LONGCTX_LAYOUT
    B, H, KH, D, bs = L["B"], L["H"], L["KH"], L["D"], L["bs"]
    pool_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    dname = "bf16" if pool_dtype == torch.bfloat16 else "f32"
    q, k_pages, v_pages, bt, lens, readout = longctx_inputs(
        ctx, device, pool_dtype)

    cm = CostModel.from_named("hopper_h100")
    lanes = max(int(getattr(cm.hw, "n_cores", 1)), 1)
    tn = get_tunable("paged_attention")
    shapes = {"batch": B, "heads": H, "kv_heads": KH, "head_dim": D,
              "ctx": ctx}

    def predict_s(ct):
        census = dict(tn.census(shapes, {"block_size": bs,
                                         "chunk_tokens": ct}, dname))
        census.pop("mxu_shape", None)
        return cm.predict(census, dtype=dname).step_s

    pred = {ct: predict_s(ct) for ct in CHUNKS}
    predicted_best = min(CHUNKS, key=lambda ct: (pred[ct], ct))
    tuned = Autotuner(cm, dtype=dname).tune("paged_attention", shapes)
    tuned_chunk = int(tuned.best["chunk_tokens"])

    def run(ct, q=q, k_pages=k_pages, v_pages=v_pages):
        return ops.paged_attention(q, k_pages, v_pages, bt, lens,
                                   chunk_tokens=ct)

    def greedy(out):
        logits = out.reshape(B, H * D).float() @ readout
        return torch.argmax(logits, dim=-1).tolist()

    iters = 5 if quick else 20
    copies = cold_copies((q, k_pages, v_pages), device, limit=iters)
    times = {}
    for ct in dict.fromkeys((chunk, CHUNK_TOKENS, predicted_best,
                             tuned_chunk)):
        times[ct] = device_time(
            [functools.partial(run, ct, *c) for c in copies], iters=iters,
            warmup=2, device=device)
    out_this, out_default = run(chunk), run(CHUNK_TOKENS)
    oracle = paged_attention_ref(q, k_pages, v_pages, bt, lens)
    toks = greedy(out_this)
    identical = toks == greedy(out_default) == greedy(oracle)

    def tok_s(ct):
        return B / max(times[ct], 1e-12)

    return {
        "ctx": ctx, "chunk_tokens": chunk, "lanes": lanes,
        "pool_dtype": dname, "n_chunks": chunk_grid(-(-ctx // bs), bs, chunk),
        "kernel_us": times[chunk] * 1e6,
        "tok_s": tok_s(chunk),
        "default_tok_s": tok_s(CHUNK_TOKENS),
        "speedup": tok_s(chunk) / tok_s(CHUNK_TOKENS),
        "tuned_chunk": tuned_chunk,
        "tuned_tok_s": tok_s(tuned_chunk),
        "tuned_speedup": tok_s(tuned_chunk) / tok_s(CHUNK_TOKENS),
        "predicted_s": pred[chunk],
        "predicted_default_s": pred[CHUNK_TOKENS],
        "predicted_speedup": pred[CHUNK_TOKENS] / max(pred[chunk], 1e-30),
        "predicted_best_chunk": predicted_best,
        "tuner_best_config": dict(tuned.best),
        "tuner_cache_key": tuned.key,
        "tokens": toks,
        "identical_tokens": bool(identical),
        "max_abs_err_vs_ref": float((out_this.float() - oracle.float())
                                    .abs().max()),
        "max_abs_ref": float(oracle.float().abs().max()),
    }


ISA_CASES = ("add.f32", "mul.f32", "fma.f32", "div.f32", "rsqrt.f32",
             "exp.f32", "tanh.f32", "softmax.f32", "matmul.f32",
             "reduce.f32", "gather", "scan8")

_ALU_OPS = tuple(ALU_OPS)


def run_traffic_scaling_cell(params: Dict[str, Any], quick: bool = False,
                             device=None) -> Dict[str, Any]:
    """The cluster tier under offered load: one skewed trace (every
    ``period``-th request long, period = replica count, so round-robin
    piles the long ones onto one replica) served by an N-replica
    ``ServingCluster`` of real engines on ``device`` under the
    parallel-replica virtual clock, once per placement policy, priced by
    the H100's measured table.  Reports tok/s, p50/p99 latency, shed
    rate, reroute/preemption counts, token conservation, and the
    cost-model-chosen topology for the device budget.  On the card the
    replicas share one device and the clock advances by host walls
    (``serve.cluster.traffic``)."""
    import numpy as np

    from repro_torch.core.costmodel import CostModel
    from repro_torch.serve.cluster import (ServingCluster, serve_trace,
                                           skewed_trace)
    from repro_torch.serve.cluster.traffic import (decode_topology,
                                                   steady_step_s,
                                                   tokens_by_index,
                                                   trace_summary)
    from repro_torch.serve.engine import PagedServingEngine
    from repro_torch.serve.sim import SimClock
    device = resolve_device(device)

    r = int(params["replicas"])
    load = float(params["load"])
    n_req = (4 * r if quick else 8 * r)
    cfg, model, weights = _serving_setup(device)
    cm = CostModel.from_named("hopper_h100")
    max_batch, max_len, bs, chunk = 4, 64, 8, 16
    # per-replica pool: ~60% of the slot-equivalent rectangle, same ratio
    # as paged_serve: tight enough that a long-request pileup preempts
    n_blocks = max(-(-max_len // bs),
                   int(0.6 * max_batch * (-(-max_len // bs))))
    period = max(r, 2)

    def build_cluster(policy):
        clock = SimClock()
        cl = ServingCluster.build(
            model, weights, n_replicas=r, policy=policy, clock=clock,
            cost_model=cm, max_batch=max_batch, max_len=max_len,
            block_size=bs, n_blocks=n_blocks, chunk_size=chunk,
            shed_wait_s=float(params.get("shed_wait_s", 30.0)))
        return cl, clock

    def bare_engine():
        return PagedServingEngine(model, weights, max_batch=max_batch,
                                  max_len=max_len, block_size=bs,
                                  n_blocks=n_blocks, chunk_size=chunk)

    # the arrival gap from this machine: a warm engine's steady step
    rng = np.random.default_rng(0)
    warm_prompts = [rng.integers(0, cfg.vocab_size, size=5).astype(np.int32)
                    for _ in range(2)]
    interval_s = steady_step_s(bare_engine, warm_prompts)

    out: Dict[str, Any] = {
        "replicas": r, "load": load, "n_requests": n_req,
        "interval_s": interval_s, "n_blocks_per_replica": n_blocks,
    }
    trace = skewed_trace(n_req, vocab=cfg.vocab_size, period=period,
                         long_len=32, short_len=4, long_new=16, short_new=4,
                         interval_s=interval_s, load=load)
    tokens_by_policy: Dict[str, Dict[int, list]] = {}
    for key, policy in (("rr", "round_robin"), ("ca", "cost_aware")):
        cl, clock = build_cluster(policy)
        # warm every replica outside the router so the timed trace
        # measures steady-state decode, then rewind the clock
        for eng in cl.replicas:
            for p in warm_prompts:
                eng.submit(p, max_new_tokens=4)
            eng.run_until_done(max_steps=20_000)
        clock.t = 0.0
        admitted = serve_trace(cl, trace, clock, min_dt=interval_s / 4,
                               max_ticks=50_000)
        summary = trace_summary(cl, admitted, clock, len(trace))
        if summary["conserved"]:
            # drained-trace invariant: every per-request router dict
            # (_local/_origin/_moves) must be pruned
            cl.router.assert_drained()
        tokens_by_policy[key] = tokens_by_index(cl, admitted,
                                                interval_s / load)
        out.update({f"{key}_{k}": v for k, v in summary.items()})

    # greedy decode is deterministic per request, so the two policies must
    # produce identical tokens for every trace index both admitted
    shared = set(tokens_by_policy["rr"]) & set(tokens_by_policy["ca"])
    out["identical_tokens"] = all(
        tokens_by_policy["rr"][i] == tokens_by_policy["ca"][i]
        for i in shared)
    if r == 1:
        # ...and at one replica the cluster must give a bare paged
        # engine's tokens for the same prompts
        eng = bare_engine()
        rids = [eng.submit(np.asarray(p, np.int32), max_new_tokens=new,
                           eos_id=eos) for _, p, new, eos in trace]
        eng.run_until_done(max_steps=50_000)
        bare = {i: list(eng.done[rid].tokens) for i, rid in enumerate(rids)}
        out["identical_tokens"] = out["identical_tokens"] and all(
            tokens_by_policy["ca"][i] == bare[i]
            for i in tokens_by_policy["ca"])
    out["speedup_tok_s"] = (out["ca_tok_per_s"]
                            / max(out["rr_tok_per_s"], 1e-9))
    out["p99_ratio"] = out["rr_p99_s"] / max(out["ca_p99_s"], 1e-9)

    # what the cost model would buy with an r-device budget
    top = decode_topology(cfg, max_len, max_batch, r, cm)
    out["topology_replicas"] = top.n_replicas
    out["topology_data"] = top.plan.data
    out["topology_model"] = top.plan.model
    out["topology_pred_tok_s"] = top.predicted_tok_s
    return out


def run_chaos_serving_cell(params: Dict[str, Any], quick: bool = False,
                           device=None) -> Dict[str, Any]:
    """One chaos drill: a seeded fault of ``params['fault']`` injected
    into a ``params['replicas']``-wide paged cluster under SimClock (the
    fake model's tensors on ``device``), with detection (heartbeats /
    straggler ceiling / integrity probe), router-level request recovery
    and restart-budget rejoin, then the recovery invariants checked
    against a fault-free twin of the same trace
    (``repro_torch.serve.chaos.drill``).  ``ok`` summarizes the cell's
    gate: identical survivors, all requests accounted, zero lost tokens,
    zero leaked blocks, at least one fault detected, and, for
    ``crashloop``, the breaker quarantining the flapper."""
    from repro_torch.serve.chaos.drill import run_chaos_drill
    device = resolve_device(device)

    fault = str(params["fault"])
    replicas = int(params["replicas"])
    out = run_chaos_drill(fault, replicas, n_requests=8 if quick else 12,
                          device=device)
    ok = (out["survivors_identical"] and out["all_accounted"]
          and out["tokens_lost"] == 0 and out["blocks_leaked"] == 0
          and out["failures"] >= 1)
    if fault == "crashloop":
        ok = ok and out["quarantined"]
    out["ok"] = bool(ok)
    return out


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
    name="autotune",
    description="cost-model-guided kernel autotuning: ranked launch "
                "configs per tunable kernel over the card's launch space "
                "(analytic; 'measured' adds the top-K timed on the device)",
    grid={"kernel": ("flash_attention", "paged_attention", "ssm_scan",
                     "wkv6", "mxu_probe"),
          "dtype": ("bf16",),
          "mode": ("analytic", "measured")},
    quick_grid={"kernel": ("flash_attention", "paged_attention", "ssm_scan",
                           "wkv6", "mxu_probe"),
                "dtype": ("bf16",),
                "mode": ("analytic",)},
    runner=run_autotune_cell,
    cost_per_cell_s=6.0,
    tags=("autotune", "costmodel"),
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
    name="telemetry_replay",
    description="production-telemetry scenarios on the sim harness: "
                "injected cost-model drift -> one online recalibration "
                "(error back under the 10% gate), and burst overload "
                "under the SLO token bucket (p99 held, newest shed)",
    grid={"scenario": ("drift", "overload")},
    runner=run_telemetry_replay_cell,
    cost_per_cell_s=20.0,
    tags=("serve", "telemetry", "costmodel"),
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

register(Experiment(
    name="decode_longctx",
    description="long-context decode attention over the paged kernel's "
                "token chunk: kernel time and tok/s vs the default chunk, "
                "the cost model's predicted best chunk, greedy-token "
                "equality vs the oracle (the reference sweeps num_splits, "
                "which changes no work on the card; the chunk is the "
                "kernel's own grid axis)",
    grid={"ctx": (256, 1024, 4096), "chunk_tokens": (32, 64, 128)},
    quick_grid={"ctx": (128, 512), "chunk_tokens": (32, 64)},
    runner=run_decode_longctx_cell,
    cost_per_cell_s=15.0,
    tags=("serve", "kernels", "longctx"),
))

register(Experiment(
    name="chaos_serving",
    description="deterministic fault drills on the serving cluster: "
                "crash / hang / corrupt / crash-loop x replica count "
                "under SimClock — heartbeat+straggler+integrity "
                "detection, router request recovery with retry budget, "
                "brownout admission, restart-budget quarantine; gates "
                "byte-identical survivors, zero lost tokens, zero "
                "leaked blocks, drained router",
    grid={"fault": ("crash", "hang", "corrupt", "crashloop"),
          "replicas": (2, 3)},
    quick_grid={"fault": ("crash", "hang", "corrupt", "crashloop"),
                "replicas": (2,)},
    runner=run_chaos_serving_cell,
    cost_per_cell_s=30.0,
    tags=("serve", "cluster", "chaos"),
))

register(Experiment(
    name="traffic_scaling",
    description="multi-replica cluster under offered load x replica "
                "count: skewed trace served round-robin vs cost-aware "
                "placement on real arrays under the parallel-replica "
                "virtual clock — tok/s, p50/p99 latency, shed rate, "
                "reroutes, token conservation, chosen topology",
    grid={"replicas": (1, 2, 4), "load": (1.0, 2.0)},
    quick_grid={"replicas": (1, 2), "load": (2.0,)},
    runner=run_traffic_scaling_cell,
    cost_per_cell_s=60.0,
    tags=("serve", "cluster", "costmodel"),
))
