#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines (a failing phase raises, so the run
exits non-zero):

1. card: the ``nvidia-smi`` name and power limit, and the build of every
   CUDA kernel from this checkout's sources (one nvcc per source, all at
   once).
2. kernel: the paged-attention kernel against its plain PyTorch version at
   the serving shapes (B=8, H=8, KH=4, D=256, block 16, 64-entry tables,
   bf16 pools), ragged contexts {0, 1, 17, 300, 1024} with a -1 entry
   inside one context, window {None, 8, 4096} x softcap {None, 50} x
   num_splits {1, 4}; with times for the kernel, the plain version,
   ``F.scaled_dot_product_attention`` over the gathered K/V (a yardstick
   only) and the memory bound.
3. serve: full-width gemma2-2b (26 layers, seeded random bf16 weights)
   through ``PagedServingEngine`` (max_batch 8, max_len 1024, block 16,
   chunk 64) on 8 requests of 16-900 prompt tokens, 32 new tokens each,
   under ``torch.cuda.set_sync_debug_mode("error")``; every decode step of
   every layer must go through the kernel.
4. parity: one batched full-width decode step through the kernel and
   through the plain version; logits must agree.
5. flash_kernel: the flash-attention kernel against its plain version,
   bf16, B=1, H=8, KH=4, D=256, Sq=Skv in {1, 52, 768, 900} (ragged
   tails of the serve trace) and B=8, Sq=Skv=512, each causal with window
   {None, 64, 4096} x softcap {None, 50}; plus one non-causal case and
   one ``acc_dtype="bf16"`` case; with times for the kernel, the plain
   version, ``F.scaled_dot_product_attention`` where it computes the
   same function (no window, no softcap; a yardstick only) and the bound.
6. serve_slot: the same model and prompts through ``ServingEngine``
   (max_batch 8, max_len 1024), under sync debugging; every layer of
   every prefill must go through the flash kernel.
7. parity_slot: one full-width prefill of a 900-token prompt through the
   flash kernel and through its plain version; logits must agree.
8. reference: a reduced f32 gemma2 served on the card and on the CPU
   (where attention runs the plain versions), through the paged and the
   slot engine, must give identical tokens.
9. probes: the paper's three probe kernels against their plain versions:
   ``alu_chain`` for every (op, dtype, dependent) the harness runs, at
   length 12; ``pointer_chase`` in shared memory and in global memory under
   ``.ca``/``.cg``/``.cv``, on cycles of 64, 4096 and 2^20 entries (shared
   where the array fits); ``mxu_probe`` on the JAX kernel tests' sweep and
   the ``mxu_shapes`` grid's shapes; with times for the kernel, the plain
   version, ``torch.matmul`` (``mxu_probe`` at chain 1) and the bound.
10. calibration: the port's campaign runs the full grids of the four
   calibration experiments (alu_chain, memory_chase, mxu_shapes,
   roofline_calibration) through the probe kernels into
   ``chiprun_out/campaign/`` and writes the table they make to
   ``chiprun_out/hopper_h100.json``; it fails on an error cell other than
   the three ``(512,512,128)`` dependent ``mxu_shapes`` cells that the
   reference fails too, a dependent ALU cell under 1 cycle per op (a folded
   chain), or a 64 MiB chase no slower per hop than a 16 KiB one.

The line before the last holds every kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the port's
sources beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
BF16_OPS_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12             # H100 SXM f32 outside the tensor cores
OUT = ROOT / "chiprun_out"
KERNEL_TOL = dict(atol=1e-2, rtol=1e-2)
LOGIT_ATOL = 0.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_ms(torch, fn, reps, flush=None):
    """Median device time of ``fn`` over ``reps`` launches (CUDA events),
    with the L2 cache flushed before each when ``flush`` is given."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name in libs:
        print(f"[{name}] nvcc:\n{_build.BUILD_LOG[name]['log']}",
              file=sys.stderr)
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "kernels_built": sorted(libs)})
    return card


def _kernel_inputs(torch, np, dev, seed):
    B, H, KH, D, bs, NB = 8, 8, 4, 256, 16, 64
    ctxs = [0, 1, 17, 300, 1024, 1024, 300, 17]
    rng = np.random.default_rng(seed)
    pages = sum(-(-c // bs) for c in ctxs)
    P = 256
    perm = rng.permutation(P)
    bt = np.full((B, NB), -1, np.int32)
    used = 0
    for b, c in enumerate(ctxs):
        n = -(-c // bs)
        bt[b, :n] = perm[used:used + n]
        used += n
    assert used == pages <= P
    bt[3, 5] = -1                           # unbacked page inside ctx 300
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
    kp = torch.randn((P, bs, KH, D), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((P, bs, KH, D), generator=g, device=dev).to(torch.bfloat16)
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.tensor(ctxs, dtype=torch.int32, device=dev), bt, ctxs)


def _bound_ms(bt, ctxs, window, H, KH, D, bs):
    """Least time for the work these inputs need: every K and V row of the
    valid context (inside the window, in a backed page) read once, q read
    and the output written once; against the bf16 op count."""
    tokens = 0
    for b, c in enumerate(ctxs):
        lo = max(0, c - window) if window else 0
        tokens += sum(1 for t in range(lo, c) if bt[b, t // bs] >= 0)
    nbytes = tokens * KH * D * 2 * 2 + 2 * len(ctxs) * H * D * 2 \
        + bt.size * 4 + len(ctxs) * 4
    ops = tokens * H * D * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel(torch, np, dev, seed):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention

    q, kp, vp, bt, ctx, bt_np, ctxs = _kernel_inputs(torch, np, dev, seed)
    B, H, D = q.shape
    KH, bs = kp.shape[2], kp.shape[1]
    scale = D ** -0.5
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    # the library yardstick: SDPA over K/V gathered to contiguous [B,H,L,D]
    k_all = ref.gather_pages(kp, bt).repeat_interleave(H // KH, 2)
    v_all = ref.gather_pages(vp, bt).repeat_interleave(H // KH, 2)
    k_all, v_all = (t.permute(0, 2, 1, 3).contiguous() for t in (k_all, v_all))
    L = k_all.shape[2]
    lslot = torch.arange(L, device=dev)
    page_ok = bt.long()[:, lslot // bs] >= 0
    cases, max_err = [], 0.0
    for window in (None, 8, 4096):
        for softcap in (None, 50.0):
            for ns in (1, 4):
                kw = dict(scale=scale, window=window, softcap=softcap,
                          num_splits=ns)
                out = paged_attention(q, kp, vp, bt, ctx, **kw)
                torch.cuda.synchronize()
                want = ref.paged_attention_plain(q, kp, vp, bt, ctx, **kw)
                err = (out.float() - want.float()).abs().max().item()
                torch.testing.assert_close(out.float(), want.float(),
                                           **KERNEL_TOL)
                max_err = max(max_err, err)
                ms = gpu_ms(torch, lambda: paged_attention(
                    q, kp, vp, bt, ctx, **kw), 30, flush)
                plain_ms = gpu_ms(torch, lambda: ref.paged_attention_plain(
                    q, kp, vp, bt, ctx, **kw), 5, flush)
                lib_ms = None
                if softcap is None:       # SDPA has no logit softcap
                    valid = (lslot[None] < ctx[:, None].long()) & page_ok
                    if window:
                        valid &= (ctx[:, None].long() - 1 - lslot[None]) \
                            < window
                    mask = valid[:, None, None, :]
                    q4 = q[:, :, None, :]
                    lib_ms = gpu_ms(torch, lambda: F.scaled_dot_product_attention(
                        q4, k_all, v_all, attn_mask=mask, scale=scale), 30, flush)
                bound, bound_by = _bound_ms(bt_np, ctxs, window, H, KH, D, bs)
                case = {"window": window, "softcap": softcap,
                        "num_splits": ns, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": bound, "bound_by": bound_by}
                cases.append(case)
                emit({"phase": "kernel", "name": "paged_attention", **case})
    return cases, max_err


def _flash_bound_ms(B, Sq, Skv, H, KH, D, causal, window, elem=2):
    """Least time for the work these inputs need: Q, K, V read once and
    the output written once, against the bf16 operations of the (query,
    key) pairs the mask keeps (2 * D for the score, 2 * D for P @ V)."""
    import numpy as np
    qp = np.arange(Sq)
    hi = np.minimum(qp, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(Sq, int)
    pairs = int(np.clip(hi - lo + 1, 0, None).sum())
    nbytes = elem * D * (2 * B * Sq * H + 2 * B * Skv * KH)
    ops = 4 * D * H * B * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_flash_kernel(torch, dev, seed):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                      kernel_tiles)

    H, KH, D = 8, 4, 256
    scale = D ** -0.5
    cases = [dict(B=B, S=S, window=w, softcap=c, causal=True, acc="f32")
             for B, S in ((1, 1), (1, 52), (1, 768), (1, 900), (8, 512))
             for w in (None, 64, 4096) for c in (None, 50.0)]
    cases += [dict(B=1, S=900, window=None, softcap=None, causal=False,
                   acc="f32"),
              dict(B=1, S=900, window=4096, softcap=50.0, causal=True,
                   acc="bf16")]
    g = torch.Generator(device=dev).manual_seed(seed)
    out_cases, max_err = [], 0.0
    for c in cases:
        B, S = c["B"], c["S"]
        q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
        k = torch.randn((B, S, KH, D), generator=g, device=dev).bfloat16()
        v = torch.randn((B, S, KH, D), generator=g, device=dev).bfloat16()
        kw = dict(causal=c["causal"], window=c["window"],
                  softcap=c["softcap"], scale=scale, acc_dtype=c["acc"])
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention_plain(q, k, v, **kw)
        err = (out.float() - want.float()).abs().max().item()
        torch.testing.assert_close(out.float(), want.float(), **KERNEL_TOL)
        max_err = max(max_err, err)
        ms = gpu_ms(torch, lambda: flash_attention(q, k, v, **kw), 20)
        plain_ms = gpu_ms(torch, lambda: ref.flash_attention_plain(
            q, k, v, **kw), 3)
        lib_ms = None
        if c["window"] is None and c["softcap"] is None:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib_ms = gpu_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=c["causal"], scale=scale,
                enable_gqa=True), 20)
        bound, bound_by = _flash_bound_ms(B, S, S, H, KH, D, c["causal"],
                                          c["window"])
        case = {"B": B, "Sq": S, "Skv": S, "causal": c["causal"],
                "window": c["window"], "softcap": c["softcap"],
                "acc_dtype": c["acc"],
                "tiles": kernel_tiles(H, KH, D, S, 128, c["acc"]),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bound,
                "bound_by": bound_by}
        out_cases.append(case)
        emit({"phase": "flash_kernel", "name": "flash_attention", **case})
    return out_cases, max_err


def _wrappers():
    from repro_torch.kernels.alu_chain import alu_chain
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mxu_probe import mxu_probe
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.pointer_chase import pointer_chase
    return {f.__name__: f for f in (paged_attention, flash_attention,
                                    alu_chain, pointer_chase, mxu_probe)}


def reset_launches():
    """Zero every kernel's launch count, just before a path is driven."""
    for f in _wrappers().values():
        f.launches = 0


def launch_counts():
    return {name: f.launches for name, f in _wrappers().items()}


def phase_serve(torch, np, dev, seed):
    from repro_torch.configs import get_config
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import PagedServingEngine

    cfg = get_config("gemma2-2b")
    model = build_model(cfg, device=dev)
    params = model.init(seed)           # matrices stored once in bf16
    kw = dict(max_batch=8, max_len=1024, block_size=16, chunk_size=64)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 901, size=8)]

    warm = PagedServingEngine(model, params, **kw)
    warm.submit(prompts[0][:40], max_new_tokens=4)
    warm.run_until_done()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    eng = PagedServingEngine(model, params, **kw)
    rids = [eng.submit(p, max_new_tokens=32) for p in prompts]
    step_ms, run_s, counts = drive(torch, eng)
    launches = counts["paged_attention"]
    st = eng.stats
    eng.allocator.check()
    if st.completed != 8:
        raise AssertionError(f"completed {st.completed} of 8 requests")
    if eng.allocator.n_free != eng.n_blocks:
        raise AssertionError("blocks leaked")
    if st.host_syncs > st.steps + 1:
        raise AssertionError(f"{st.host_syncs} syncs over {st.steps} steps")
    if launches == 0 or launches != cfg.n_layers * st.decode_dispatches:
        raise AssertionError(f"{launches} kernel launches != {cfg.n_layers}"
                             f" x {st.decode_dispatches} decode dispatches")
    toks = [eng.done[r].tokens for r in rids]
    if any(len(t) != 32 or min(t) < 0 or max(t) >= cfg.vocab_size
           for t in toks):
        raise AssertionError("a request came back short or out of vocab")
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
          "requests": len(prompts), "prompt_tokens": [len(p) for p in prompts],
          "completed": st.completed, "decoded_tokens": st.decoded_tokens,
          "steps": st.steps, "decode_dispatches": st.decode_dispatches,
          "prefill_chunks": st.prefill_chunks, "host_syncs": st.host_syncs,
          "table_uploads": st.table_uploads, "compactions": st.compactions,
          "kernel_launches": counts, "run_s": run_s,
          "decode_tok_per_s": st.decoded_tokens / run_s,
          "median_step_ms": statistics.median(step_ms),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "kv_pool_gib": eng.kv_cache_bytes() / 2 ** 30})
    del eng
    torch.cuda.empty_cache()
    return model, params, prompts, launches


def drive(torch, eng):
    """Step ``eng`` to the end under sync debugging ("error"), with every
    launch count zeroed just before; returns each step's host ms, the
    run's wall seconds and the launch counts read just after."""
    step_ms = []
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    t_run = time.perf_counter()
    try:
        while True:
            t0 = time.perf_counter()
            active = eng.step()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            if active == 0 and not eng.queue:
                break
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    return step_ms, run_s, launch_counts()


def phase_serve_slot(torch, model, params, prompts):
    """The paged phase's model and prompts through the slot engine."""
    from repro_torch.serve.engine import ServingEngine

    cfg = model.cfg
    kw = dict(max_batch=8, max_len=1024)
    warm = ServingEngine(model, params, **kw)
    warm.submit(prompts[0][:40], max_new_tokens=4)
    warm.run_until_done()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    eng = ServingEngine(model, params, **kw)
    rids = [eng.submit(p, max_new_tokens=32) for p in prompts]
    step_ms, run_s, counts = drive(torch, eng)
    launches = counts["flash_attention"]
    st = eng.stats
    if st.completed != len(prompts):
        raise AssertionError(f"completed {st.completed} of {len(prompts)}")
    if st.host_syncs > st.steps + 1:
        raise AssertionError(f"{st.host_syncs} syncs over {st.steps} steps")
    if launches == 0 or launches != cfg.n_layers * st.prefills:
        raise AssertionError(f"{launches} flash launches != {cfg.n_layers}"
                             f" x {st.prefills} prefills")
    toks = [eng.done[r].tokens for r in rids]
    if any(len(t) != 32 or min(t) < 0 or max(t) >= cfg.vocab_size
           for t in toks):
        raise AssertionError("a request came back short or out of vocab")
    emit({"phase": "serve_slot", "arch": cfg.name, "layers": cfg.n_layers,
          "requests": len(prompts), "completed": st.completed,
          "decoded_tokens": st.decoded_tokens, "steps": st.steps,
          "prefills": st.prefills, "host_syncs": st.host_syncs,
          "kernel_launches": counts, "run_s": run_s,
          "decode_tok_per_s": st.decoded_tokens / run_s,
          "median_step_ms": statistics.median(step_ms),
          "first_step_ms": step_ms[0],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "slot_cache_gib": eng.kv_cache_bytes() / 2 ** 30})
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_parity(torch, np, model, params, seed):
    """One full-width batched decode step through the kernel, and through
    the plain version called explicitly, on the same pool."""
    from repro_torch.kernels.ref import paged_attention_plain

    cfg, dev = model.cfg, model.device
    B, bs, NB = 8, 16, 64
    cache = model.init_paged_cache(B * NB, bs)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=g, device=dev))
    bt = torch.arange(B * NB, dtype=torch.int32, device=dev).view(B, NB)
    pos = torch.tensor([0, 16, 299, 1000, 500, 63, 777, 128],
                       dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device=dev)
    twin = {k: v.clone() for k, v in cache.items()}
    lk, _ = model.decode(params, cache, toks, pos, bt)
    lp, _ = model.decode(params, twin, toks, pos, bt,
                         paged_fn=paged_attention_plain)
    diff = (lk - lp).abs().max().item()
    mean_diff = (lk - lp).abs().mean().item()
    flips = int((lk.argmax(-1) != lp.argmax(-1)).sum().item())
    if not torch.isfinite(lk).all() or diff > LOGIT_ATOL:
        raise AssertionError(f"kernel vs plain logits differ by {diff}")
    emit({"phase": "parity", "logit_max_abs_diff": diff,
          "logit_mean_abs_diff": mean_diff,
          "logit_atol": LOGIT_ATOL, "logit_std": lk.float().std().item(),
          "greedy_tokens_differing": flips, "rows": B})


def phase_parity_slot(torch, np, model, params, seed):
    """One full-width prefill of a 900-token prompt through the flash
    kernel, and through the plain version called explicitly."""
    from repro_torch.kernels.ref import flash_attention_plain

    rng = np.random.default_rng(seed + 2)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         size=(1, 900)).astype(np.int32))
    batch = {"tokens": toks.to(model.device)}
    lk, ck = model.prefill(params, batch, max_len=1024)
    lp, _ = model.prefill(params, batch, max_len=1024,
                          flash_fn=flash_attention_plain)
    diff = (lk - lp).abs().max().item()
    mean_diff = (lk - lp).abs().mean().item()
    flipped = bool((lk.argmax(-1) != lp.argmax(-1)).any().item())
    if not torch.isfinite(lk).all() or diff > LOGIT_ATOL:
        raise AssertionError(f"flash kernel vs plain logits differ by {diff}")
    if tuple(ck["k"].shape) != (model.cfg.n_layers, 1, 1024,
                                model.cfg.n_kv_heads, model.cfg.head_dim):
        raise AssertionError(f"prefill cache shape {tuple(ck['k'].shape)}")
    emit({"phase": "parity_slot", "prompt_tokens": 900,
          "logit_max_abs_diff": diff, "logit_mean_abs_diff": mean_diff,
          "logit_atol": LOGIT_ATOL, "logit_std": lk.float().std().item(),
          "greedy_token_flipped": flipped})


def phase_reference(torch, np, seed):
    """Reduced f32 gemma2 served on the card (kernels) and on the CPU
    (plain attention), through both engines: the tokens must be
    identical."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import params_to
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import PagedServingEngine, ServingEngine

    cfg = reduced(get_config("gemma2-2b"), n_layers=2, vocab_size=128,
                  compute_dtype="float32")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 40, size=8)]
    engines = {
        "paged": lambda m, p: PagedServingEngine(
            m, p, max_batch=4, max_len=64, block_size=8, n_blocks=12,
            chunk_size=8),
        "slot": lambda m, p: ServingEngine(m, p, max_batch=4, max_len=64)}
    cpu_params = build_model(cfg, device="cpu").init(seed)
    same = {}
    for name, make in engines.items():
        out = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, device=dev)
            eng = make(model, params_to(cpu_params, dev))
            rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
            eng.run_until_done()
            out[dev] = [eng.done[r].tokens for r in rids]
        same[name] = out["cuda"] == out["cpu"]
    if not all(same.values()):
        raise AssertionError(f"card and CPU tokens differ on the reduced "
                             f"f32 model: {same}")
    emit({"phase": "reference", "arch": cfg.name, "layers": cfg.n_layers,
          "requests": len(prompts), "tokens_identical": same})


def _bound(nbytes, ops, ops_per_s):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_probes(torch, np, dev, seed):
    """Each probe kernel against its plain version on the card; one timed
    case per kernel for the kernels line."""
    from repro_torch.core.microbench.memory import _random_cycle
    from repro_torch.core.microbench.mxu import dependent_block
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.alu_chain import tolerance
    from repro_torch.kernels.mxu_probe import REL_TOL

    rng = np.random.default_rng(seed)
    c = 1.0009765625
    worst = {"alu_chain": 0.0, "pointer_chase": 0.0, "mxu_probe": 0.0}
    n_alu = 0
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        if dt == torch.int32:
            x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (8, 128))
                                 .astype(np.int32)).to(dev)
        else:
            x = torch.from_numpy((rng.normal(size=(8, 128)) + 2.0)
                                 .astype(np.float32)).to(dt).to(dev)
        cv = torch.tensor(c).to(dt).to(dev)
        for op in ref.ALU_OPS:
            if not ref.alu_legal(op, dt):
                continue
            for dep in (True, False):
                out = ops.alu_chain(x, cv, op=op, length=12, dependent=dep)
                torch.cuda.synchronize()
                want = ref.alu_chain_plain(x, cv, op=op, length=12,
                                           dependent=dep)
                torch.testing.assert_close(out.double(), want.double(),
                                           equal_nan=True,
                                           **tolerance(op, dt, 12))
                worst["alu_chain"] = max(worst["alu_chain"], (
                    out.double() - want.double()).abs().max().item())
                n_alu += 1
    # the kernels line's case: the f32 fma chain of the harness's longest
    # length, dependent, on its (8,128) tile
    x = torch.linspace(0.5, 1.5, 1024, device=dev).reshape(8, 128)
    cv = torch.tensor(c, device=dev)
    kw = dict(op="fma", length=256, dependent=True)
    alu = {"case": "fma f32 dependent, length 256, (8,128)",
           "ms": gpu_ms(torch, lambda: ops.alu_chain(x, cv, **kw), 30),
           "plain_ms": gpu_ms(torch, lambda: ref.alu_chain_plain(x, cv, **kw),
                              5),
           "library_ms": None}
    alu["bound_ms"], alu["bound_by"] = _bound(2 * 1024 * 4 + 12,
                                              2 * 1024 * 256, F32_OPS_PER_S)
    emit({"phase": "probes", "name": "alu_chain", "cases": n_alu,
          "length": 12, "max_abs_err": worst["alu_chain"], **alu})

    chase = None
    n_chase = 0
    for n in (64, 4096, 1 << 20):
        nxt = torch.from_numpy(_random_cycle(n, seed + n)).to(dev)
        hops = min(4 * n, 4096)
        want = int(ref.pointer_chase_plain(nxt, 1, hops))
        for space, cop in (("shared", "ca"), ("global", "ca"),
                           ("global", "cg"), ("global", "cv")):
            if space == "shared" and n > 50000:
                continue                    # 4 MiB does not fit 227 KB
            got = int(ops.pointer_chase(nxt, 1, hops=hops, space=space,
                                        cache_op=cop))
            if got != want:
                raise AssertionError(f"pointer_chase {space}/{cop} n={n}: "
                                     f"{got} != {want}")
            n_chase += 1
        if n == 1 << 20:
            kw = dict(hops=4096, space="global", cache_op="ca")
            chase = {"case": "global .ca, 2^20 entries (4 MiB), 4096 hops",
                     "ms": gpu_ms(torch, lambda: ops.pointer_chase(
                         nxt, 1, **kw), 20),
                     "plain_ms": gpu_ms(torch, lambda: ref.pointer_chase_plain(
                         nxt, 1, 4096), 3),
                     "library_ms": None}
            chase["bound_ms"], chase["bound_by"] = _bound(4096 * 4 + 4, 0,
                                                          F32_OPS_PER_S)
    # the paper's Fig. 2: cycles per hop in each space and under each
    # cache operator, on a warmed 16 KiB cycle (L1-, L2- and smem-sized)
    from repro_torch.core.microbench.harness import steady_slope, time_kernel
    nxt = torch.from_numpy(_random_cycle(4096, seed)).to(dev)
    fig2 = {}
    for space, cop in (("shared", "ca"), ("global", "ca"), ("global", "cg"),
                       ("global", "cv")):
        hops = (256, 1024, 4096)
        cyc = [float(np.median(time_kernel(lambda t, h=h: ops.pointer_chase(
            nxt, 0, hops=h, space=space, cache_op=cop, timing=t), 10,
            device=dev)[1])) for h in hops]
        fig2[space if space == "shared" else f"global.{cop}"] = \
            steady_slope(hops, cyc)
    emit({"phase": "probes", "name": "pointer_chase", "cases": n_chase,
          "max_abs_err": 0.0, "cycles_per_hop_16KiB": fig2, **chase})
    worst["pointer_chase"] = 0.0

    cases = [(128, 128, 128, 1), (128, 128, 128, 4), (256, 256, 128, 1),
             (256, 256, 256, 1), (256, 256, 256, 8), (512, 128, 512, 1)]
    worst_rel = 0.0
    for dt in (torch.bfloat16, torch.float32):
        for m, k, n, chain in cases:
            a = torch.from_numpy(rng.normal(size=(m, k)) * 0.1).to(dt).to(dev)
            b = torch.from_numpy(rng.normal(size=(k, n)) * 0.1).to(dt).to(dev)
            block = dependent_block(m, n, k, dt, chain) if chain > 1 else None
            out = ops.mxu_probe(a, b, chain=chain, block=block)
            torch.cuda.synchronize()
            want = ref.mxu_probe_plain(a, b, chain=chain).float()
            err = (out.float() - want).abs().max().item()
            rel = err / want.abs().max().item()
            if not rel <= REL_TOL:
                raise AssertionError(f"mxu_probe {dt} {(m, k, n, chain)}: "
                                     f"error {rel} of max > {REL_TOL}")
            worst["mxu_probe"] = max(worst["mxu_probe"], err)
            worst_rel = max(worst_rel, rel)
    a = torch.randn((256, 256), device=dev).bfloat16()
    b = torch.randn((256, 256), device=dev).bfloat16()
    mxu = {"case": "bf16 256x256x256, chain 1, block (128,128)",
           "ms": gpu_ms(torch, lambda: ops.mxu_probe(a, b, chain=1), 30),
           "plain_ms": gpu_ms(torch, lambda: ref.mxu_probe_plain(a, b), 30),
           "library_ms": gpu_ms(torch, lambda: torch.matmul(a, b), 30)}
    mxu["bound_ms"], mxu["bound_by"] = _bound(3 * 256 * 256 * 2,
                                              2 * 256 ** 3, BF16_OPS_PER_S)
    emit({"phase": "probes", "name": "mxu_probe", "cases": 2 * len(cases),
          "max_abs_err": worst["mxu_probe"], "max_err_of_max": worst_rel,
          "rel_tol": REL_TOL, **mxu})
    return {"alu_chain": alu, "pointer_chase": chase, "mxu_probe": mxu}, worst


# the cells the reference fails too: a [512,512] product cannot feed
# A [512,128] @ . in a dependent chain
REFERENCE_ERRORS = {f"dependent=true,dtype={d},shape=512x512x128"
                    for d in ("bfloat16", "float32", "int8")}


def phase_calibration(torch, dev, card):
    """The port's campaign: the four calibration experiments' full grids
    through the probe kernels, and the table they make."""
    import shutil

    from repro_torch.core.campaign.results import load_results_dir
    from repro_torch.core.microbench import tables

    results = OUT / "campaign"
    shutil.rmtree(results, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    table = tables.calibrate(quick=False, results_dir=results, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    docs = load_results_dir(results, tables.CALIBRATION_EXPERIMENTS)
    errors = sorted(f"{name}:{key}" for name, doc in docs.items()
                    for key, rec in doc["cells"].items()
                    if rec.get("status") != "ok")
    expected = sorted(f"mxu_shapes:{k}" for k in REFERENCE_ERRORS)
    if errors != expected:
        bad = [e for e in errors if e not in expected]
        raise AssertionError(f"calibration cells in error: {bad or errors}; "
                             f"expected exactly {expected}")
    alu = {(r["params"]["op"], r["params"]["dtype"], r["params"]["dependent"]):
           r["metrics"] for r in docs["alu_chain"]["cells"].values()}
    folded = sorted(f"{op}.{dt}" for (op, dt, dep), m in alu.items()
                    if dep and m["per_op_cycles"] < 1.0)
    if folded:
        raise AssertionError(f"dependent ALU cells under 1 cycle per op "
                             f"(a folded chain): {folded}")
    chase = {r["params"]["size_kib"]: r["metrics"]
             for r in docs["memory_chase"]["cells"].values()
             if r["params"]["access"] == "chase"}
    if not chase[65536]["per_hop_ns"] > chase[16]["per_hop_ns"]:
        raise AssertionError("the 64 MiB chase is not slower per hop than "
                             "the 16 KiB chase")
    for name in ("alu_chain", "pointer_chase", "mxu_probe"):
        if counts[name] == 0:
            raise AssertionError(f"the calibration never launched {name}")
    cycles = {f"{op}.{dt}": {"dependent": alu[(op, dt, True)]["per_op_cycles"],
                             "independent": alu[(op, dt, False)][
                                 "per_op_cycles"]}
              for op, dt in (("add", "float32"), ("mul", "float32"),
                             ("fma", "float32"), ("add", "int32"),
                             ("mul", "int32"), ("rsqrt", "float32"),
                             ("exp", "float32"), ("sin", "float32"),
                             ("tanh", "float32"), ("add", "bfloat16"),
                             ("fma", "bfloat16"))}
    hops = {f"{kib}KiB": {"per_hop_ns": m["per_hop_ns"],
                          "per_hop_cycles": m["per_hop_cycles"]}
            for kib, m in sorted(chase.items())}
    mxu = {key: {k: rec["metrics"].get(k) for k in
                 ("tflops", "per_op_us", "per_op_cycles", "block")}
           for key, rec in sorted(docs["mxu_shapes"]["cells"].items())
           if rec["status"] == "ok"}
    table["source"] = (f"measured on one {card} by `python3 chip_smoke.py` "
                       "(phase calibration: the full grids of alu_chain, "
                       "memory_chase, mxu_shapes and roofline_calibration "
                       "through the port's probe kernels)")
    (OUT / "hopper_h100.json").write_text(json.dumps(table, indent=1))
    emit({"phase": "calibration", "run_s": run_s, "launches": counts,
          "cells": {n: len(d["cells"]) for n, d in docs.items()},
          "seconds": {n: sum(r["elapsed_s"] for r in d["cells"].values())
                      for n, d in docs.items()},
          "errors": errors, "clock_mhz": table["clock_mhz"],
          "alu_cycles": cycles, "chase": hops, "mxu": mxu,
          "roofline": {k: v["value"] for k, v in table["roofline"].items()}})
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(SRC):
        print("chip_smoke: repro_torch does not come from this checkout",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = phase_card(torch)
    cases, max_err = phase_kernel(torch, np, dev, args.seed)
    fa_cases, fa_err = phase_flash_kernel(torch, dev, args.seed)
    model, params, prompts, launches = phase_serve(torch, np, dev, args.seed)
    fa_launches = phase_serve_slot(torch, model, params, prompts)
    phase_parity(torch, np, model, params, args.seed)
    phase_parity_slot(torch, np, model, params, args.seed)
    del model, params
    torch.cuda.empty_cache()
    phase_reference(torch, np, args.seed)
    probes, probe_err = phase_probes(torch, np, dev, args.seed)
    cal_counts = phase_calibration(torch, dev, card)

    # the kernel line: the serving shapes with neither window nor softcap
    # and one split, the one case where SDPA computes the same function
    main_case = next(c for c in cases if c["window"] is None
                     and c["softcap"] is None and c["num_splits"] == 1)
    # the flash kernel at the main path's longest prompt (B=1, Sq=900),
    # causal without window or softcap: where SDPA computes the same
    fa_case = next(c for c in fa_cases if c["B"] == 1 and c["Sq"] == 900
                   and c["causal"] and c["window"] is None
                   and c["softcap"] is None and c["acc_dtype"] == "f32")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:203",
         "launches": launches, "max_abs_err": max_err,
         **{k: main_case[k] for k in keys}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:80",
         "launches": fa_launches, "max_abs_err": fa_err,
         **{k: fa_case[k] for k in keys}}] + [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": replaces, "launches": cal_counts[name],
         "max_abs_err": probe_err[name],
         **{k: probes[name][k] for k in keys}}
        for name, replaces in (
            ("alu_chain", "src/repro/kernels/microbench_alu.py:51"),
            ("pointer_chase", "src/repro/kernels/microbench_chase.py:28"),
            ("mxu_probe", "src/repro/kernels/mxu_probe.py:26"))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
