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


def reset_launches():
    """Zero every kernel's launch count, just before a path is driven."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    paged_attention.launches = 0
    flash_attention.launches = 0


def launch_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    return {"paged_attention": paged_attention.launches,
            "flash_attention": flash_attention.launches}


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

    phase_card(torch)
    cases, max_err = phase_kernel(torch, np, dev, args.seed)
    fa_cases, fa_err = phase_flash_kernel(torch, dev, args.seed)
    model, params, prompts, launches = phase_serve(torch, np, dev, args.seed)
    fa_launches = phase_serve_slot(torch, model, params, prompts)
    phase_parity(torch, np, model, params, args.seed)
    phase_parity_slot(torch, np, model, params, args.seed)
    del model, params
    torch.cuda.empty_cache()
    phase_reference(torch, np, args.seed)

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
         **{k: fa_case[k] for k in keys}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
