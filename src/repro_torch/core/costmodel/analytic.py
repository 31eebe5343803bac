"""Analytic (first-principles) census/byte models of a step, the input
``CostModel.predict`` prices: the serving engines' admission gate prices
its prefills, chunks and decode steps through them.

The byte models take an explicit ``n_model`` so candidates with different
model-parallel widths price differently.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.models.zoo import count_active_params, count_params


def _param_bytes(cfg) -> int:
    return count_params(cfg) * 4          # f32 master weights


def cache_bytes(cfg, cell) -> float:
    """Decode-state bytes for one shape cell (KV / SSM / RWKV / MLA)."""
    B, S, L = cell.global_batch, cell.seq_len, cfg.n_layers
    if cfg.rwkv:
        H = cfg.d_model // cfg.rwkv.head_dim
        return L * B * (H * cfg.rwkv.head_dim ** 2 * 4 + 2 * cfg.d_model * 2)
    if cfg.mla:
        return L * B * S * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * 2
    kv = L * B * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    if cfg.ssm:   # hybrid: + per-layer ssm state
        kv += L * B * cfg.d_model * cfg.ssm.state_dim * 4
    if cfg.encdec:
        kv = cfg.encdec.n_dec_layers * B * S * cfg.n_kv_heads \
            * cfg.head_dim * 2 * 2 * 2   # self + cross
    return kv


def analytic_train_bytes(cfg, cell, n_devices: int, accum: int,
                         n_model: int = 16) -> float:
    """Per-device HBM bytes for one train step (lower-bound model)."""
    P = _param_bytes(cfg)
    n_model = max(min(n_model, n_devices), 1)
    n_data = max(n_devices // n_model, 1)
    P_dev = P / n_devices                 # FSDP+TP fully sharded storage
    P_stream = P / n_model                # gathered weights a device consumes
    tokens_dev = cell.global_batch * cell.seq_len / n_data
    d = cfg.d_model
    L = cfg.n_layers
    # forward + recompute + backward each stream the (gathered) weights once,
    # in bf16 compute copies (half the f32 master bytes)
    weights = 3 * accum * P_stream * 0.5
    # gradient accumulation buffer read+write per microstep (f32, sharded)
    grads = 2 * accum * (P / n_devices) * 4 / 4
    # optimizer: read p,m,v + write p,m,v (f32, sharded)
    opt = 6 * P_dev
    # activation checkpoints: write fwd, read bwd (bf16) - one carry per layer
    acts = 2 * L * tokens_dev * d * 2
    # logits written+read in f32 (vocab sharded over model axis)
    logits = 2 * tokens_dev * cfg.vocab_size / n_model * 4
    return weights + grads + opt + acts + logits


def decode_step_token_bytes(cfg, cell) -> float:
    """KV bytes one decode step *writes*: each sequence's single new
    token per layer — the only cache traffic a donated in-place update
    adds on top of the context read."""
    import dataclasses
    return cache_bytes(cfg, dataclasses.replace(cell, seq_len=1))


def decode_boundary_bytes(cfg, cell, device_sampling: bool = False) -> float:
    """Bytes a decode step hands back across the jit/step boundary to the
    host program.  The legacy path materializes the full ``[B, vocab]``
    f32 logit matrix as a step output for host-side eager sampling —
    an HBM round-trip plus an extra eager argmax dispatch and a forced
    sync per token (on host-memory backends it is literally the host
    transfer).  With sampling fused into the step, only the ``[2, B]``
    int32 token echo crosses (outputs AND echoed inputs in one buffer,
    so prefill first-tokens need no transfer of their own)."""
    B = cell.global_batch
    if device_sampling:
        return 2.0 * B * 4.0
    return B * cfg.vocab_size * 4.0


def analytic_serve_bytes(cfg, cell, n_devices: int, n_model: int = 16,
                         donated: bool = False) -> float:
    """Per-device HBM bytes for one serve step (prefill or decode).

    ``donated`` models the fused hot path's in-place cache update: an
    undonated functional step reads the whole decode cache AND writes a
    complete second copy (2x cache bytes); a donated step reads the
    context but writes only each sequence's new token slice.  The
    default (False) is the legacy engines' traffic — what the shipped
    golden predictions were recorded against."""
    P = _param_bytes(cfg)
    n_model = max(min(n_model, n_devices), 1)
    P_stream = P / n_model * 2 / 4        # bf16 weights, TP sharded
    if cfg.moe and cell.kind == "decode":
        # decode touches only active experts' weights
        act_frac = count_active_params(cfg) / count_params(cfg)
        P_stream *= act_frac
    if cell.kind == "prefill":
        n_data = max(n_devices // n_model, 1)
        tokens_dev = cell.global_batch * cell.seq_len / n_data
        d = cfg.d_model
        acts = 2 * cfg.n_layers * tokens_dev * d * 2
        cache = cache_bytes(cfg, cell) / n_devices
        return P_stream + acts + cache
    if donated:
        # decode, fused: read the context once, write one token per seq
        cache = (cache_bytes(cfg, cell)
                 + decode_step_token_bytes(cfg, cell)) / n_devices
    else:
        # decode, legacy: read the whole cache + materialize a second one
        cache = 2 * cache_bytes(cfg, cell) / n_devices
    return P_stream + cache


def analytic_route_bytes(cfg, prompt_len: int,
                         filled_tokens: int = 0) -> float:
    """Bytes one inter-replica route (or re-route) of a request moves or
    abandons — what the cluster router's cost-aware placement charges a
    candidate replica on top of its queue.

    Two terms:

    * the prompt token ids cross the datacenter fabric to the target
      host (4 B int32 each) — the only traffic a FRESH placement pays,
      which is why first placement is near-free;
    * any KV already materialized on the source replica is thrown away
      and re-written on the target: the filled prefix's cache bytes, the
      prefill replay's write traffic.  Re-routing a half-prefilled
      eviction victim therefore competes against its local front-requeue
      (which replays the same prefix but moves no tokens) — exactly the
      tradeoff ``serve.cluster.policy.CostAwarePolicy.reroute`` prices.
    """
    tok_bytes = 4.0 * max(int(prompt_len), 0)
    filled = min(max(int(filled_tokens), 0), max(int(prompt_len), 0))
    if filled == 0:
        return tok_bytes
    from repro_torch.configs.base import ShapeCell
    cell = ShapeCell("route", "prefill", filled, 1)
    return tok_bytes + cache_bytes(cfg, cell)


def analytic_step_bytes(cfg, cell, n_devices: int, accum: int = 1,
                        n_model: int = 16, donated: bool = False) -> float:
    if cell.kind == "train":
        return analytic_train_bytes(cfg, cell, n_devices, accum, n_model)
    return analytic_serve_bytes(cfg, cell, n_devices, n_model,
                                donated=donated)


# rough top-level-op count per transformer layer in an optimized module
# (fusion-dominated; anchors the issue-overhead term of analytic censuses)
_OPS_PER_LAYER = {"fusion": 30.0, "dot": 6.0, "dynamic-update-slice": 2.0,
                  "transpose": 2.0, "reshape": 4.0, "copy": 1.0}


def analytic_census(cfg, cell, n_devices: int, n_model: int = 16,
                    accum: int = 1, donated: bool = False,
                    device_sampling: bool = False) -> Dict[str, Any]:
    """A census-shaped dict (flops / hbm_bytes / collective bytes /
    op_histogram) for a candidate sharding plan, from first principles.

    Collective model (ring algorithms over the batch/model axes):
      * FSDP weight gather fwd+bwd plus gradient reduce-scatter over the
        data axis: 3 x (P/n_model) bf16 bytes x (d-1)/d;
      * TP activation combines over the model axis: 2 collectives/layer of
        per-device token activations x (m-1)/m.

    ``donated`` / ``device_sampling`` price the fused decode hot path:
    donation removes the second-cache materialization from ``hbm_bytes``
    (write only the new token slice), and on-device sampling shrinks
    ``boundary_bytes`` from the ``[B, vocab]`` f32 logit matrix handed
    to host-side sampling down to the ``[2, B]`` int32 token echo.  Both
    default to the legacy engines' traffic so recorded golden
    predictions are unchanged.
    """
    n_model = max(min(n_model, n_devices), 1)
    n_data = max(n_devices // n_model, 1)
    P = count_params(cfg)
    P_active = count_active_params(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    tokens_dev = tokens / n_data
    if cell.kind == "train":
        flops_global = 6.0 * P_active * tokens * accum
    else:
        flops_global = 2.0 * P_active * tokens
    flops_dev = flops_global / n_devices

    wire = 0.0
    if n_data > 1:
        gathers = 3 if cell.kind == "train" else 1
        wire += gathers * (P * 2 / n_model) * (n_data - 1) / n_data
    if n_model > 1:
        passes = 3 * accum if cell.kind == "train" else 1
        wire += passes * 2 * cfg.n_layers * tokens_dev * cfg.d_model * 2 \
            * (n_model - 1) / n_model

    layers_weight = cfg.n_layers * (accum * 3 if cell.kind == "train" else 1)
    hist = {k: v * layers_weight for k, v in _OPS_PER_LAYER.items()}
    if n_data > 1 or n_model > 1:
        hist["all-reduce"] = 2.0 * cfg.n_layers
        hist["all-gather"] = float(cfg.n_layers)

    out = {
        "flops": flops_dev,
        "hbm_bytes": analytic_step_bytes(cfg, cell, n_devices, accum,
                                         n_model, donated=donated),
        "collective_bytes_total": wire,
        "op_histogram": hist,
        "model_flops_global": flops_global,
    }
    if cell.kind == "decode":
        # what crosses the step boundary to the host program (informational:
        # the roofline terms do not price it, but predicted-vs-measured
        # step comparisons and the decode_hotpath experiment read it)
        out["boundary_bytes"] = decode_boundary_bytes(
            cfg, cell, device_sampling=device_sampling)
    return out
