"""Decoder-only LM trunk, dense family only: a port of
``repro.models.transformer``'s prefill and decode modes, over the dense
slot cache or the paged KV pool.

The layers run as a Python loop over per-layer parameter dicts, so each
layer's local/global flag (``cfg.layer_is_global(i)``) is a plain bool.
Other families (moe, mla, ssm, hybrid, rwkv, encoder-decoder), meta tokens
and modality frontends raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import basic


def check_supported(cfg) -> None:
    if (cfg.family != "dense" or cfg.attn_impl != "gqa" or cfg.moe
            or cfg.mla or cfg.ssm or cfg.rwkv or cfg.encdec
            or cfg.meta_tokens or cfg.frontend is not None
            or cfg.n_prefix_embeds or cfg.padded_heads != cfg.n_heads):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense GQA decoders only "
            "(no moe, mla, ssm, hybrid, rwkv, encoder-decoder, meta tokens, "
            "frontends or padded heads yet)")


def init_decode_cache(cfg, batch, max_len, device):
    """The dense slot cache ``{'k','v': [L, batch, max_len, KH, hd]}`` in
    bf16 (``attention.init_kv_cache``)."""
    check_supported(cfg)
    return attn_mod.init_kv_cache(cfg, batch, max_len, cfg.n_layers, device)


def init_paged_decode_cache(cfg, n_blocks, block_size, device):
    """The paged pool, one per layer: ``{'k','v': [L, n_blocks + 1, bs, KH,
    hd]}`` in bf16 whatever the compute dtype (as the JAX pool).  Page
    ``n_blocks`` of each layer is a trash page that takes the writes JAX
    drops (``attention.paged_write``); pages ``[0, n_blocks)`` are the
    pool proper."""
    check_supported(cfg)
    shape = (cfg.n_layers, n_blocks + 1, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _layer(x, lp, *, cfg, positions, is_global, cache, write_pos,
           block_tables, paged_fn, flash_fn):
    h = basic.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a, new_kv = attn_mod.attention(
        lp["attn"], h, cfg=cfg, positions=positions, is_global=is_global,
        cache=cache, write_pos=write_pos, block_tables=block_tables,
        paged_fn=paged_fn, flash_fn=flash_fn)
    if cfg.post_norms:
        a = basic.rmsnorm(lp["post_ln1"], a, cfg.norm_eps)
    x = x + a
    h = basic.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    f = basic.mlp(lp["ffn"], h, cfg.act)
    if cfg.post_norms:
        f = basic.rmsnorm(lp["post_ln2"], f, cfg.norm_eps)
    return x + f, new_kv


def _prefill_pad_cache(kv, max_len):
    """One layer's prefill K/V ``[B, S, KH, hd]`` cast to bf16 (the cache
    storage dtype) and zero-padded to ``max_len`` slots."""
    def pad(c):
        return F.pad(c.to(torch.bfloat16),
                     (0, 0, 0, 0, 0, max_len - c.shape[1]))
    return {key: pad(c) for key, c in kv.items()}


def _last_pos_head(x):
    """Only the final position is unembedded, so a fused decode step can
    argmax ``[B, 1, V] -> [B]`` on the device."""
    return x[:, -1:, :] if x.shape[1] > 1 else x


def lm_apply(params, cfg, *, tokens, mode, cache=None, write_pos=None,
             block_tables=None, max_len=None, paged_fn=None, flash_fn=None):
    """Run the trunk.

    tokens        [B,S] int
    mode          "prefill": the uncached forward from position 0; returns
                  the new cache {'k','v': [L, B, max_len, KH, hd]} (bf16,
                  zero-padded; ``max_len`` defaults to S).
                  "decode": S new tokens per row at ``write_pos`` (S == 1,
                  or a chunked-prefill chunk on the paged pool); ``cache``
                  (the slot cache, or with ``block_tables`` the paged pool)
                  is updated in place and returned.
    write_pos     [B] int32 position of each row's first token (decode);
                  negative positions (left pad, inactive rows) write
                  nothing into the paged pool
    block_tables  [B,NB] int32 (paged pool only)
    Returns (f32 logits [B, 1, Vpad] of the last position, cache).
    """
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode={mode!r} is not ported yet")
    cdt = getattr(torch, cfg.compute_dtype)
    B, S = tokens.shape
    x = basic.embed_tokens(params["embed"], tokens, cdt,
                           scale_by_dim=cfg.scale_embeds)
    if mode == "decode":
        positions = write_pos[:, None] + torch.arange(
            S, dtype=write_pos.dtype, device=write_pos.device)[None]
    else:
        max_len = max_len or S
        if max_len < S:
            raise ValueError(f"max_len={max_len} < prompt length {S}")
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    new = []
    for i, lp in enumerate(params["layers"]):
        layer_cache = None
        if mode == "decode":
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        x, new_kv = _layer(x, lp, cfg=cfg, positions=positions,
                           is_global=cfg.layer_is_global(i),
                           cache=layer_cache, write_pos=write_pos,
                           block_tables=block_tables, paged_fn=paged_fn,
                           flash_fn=flash_fn)
        if mode == "prefill":
            new.append(_prefill_pad_cache(new_kv, max_len))
    x = basic.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    x = _last_pos_head(x)
    logits = basic.unembed(params["embed"], x, cdt, cfg.logit_softcap,
                           vocab=cfg.vocab_size)
    if mode == "prefill":
        cache = {key: torch.stack([c[key] for c in new]) for key in ("k", "v")}
    return logits, cache
