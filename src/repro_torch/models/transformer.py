"""Decoder-only LM trunk over the paged KV pool, dense family only: a port
of ``repro.models.transformer``'s paged decode path.

The layers run as a Python loop over per-layer parameter dicts, so each
layer's local/global flag (``cfg.layer_is_global(i)``) is a plain bool.
Other families (moe, mla, ssm, hybrid, rwkv, encoder-decoder), meta tokens
and modality frontends raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

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


def _layer(x, lp, *, cfg, positions, is_global, pool_k, pool_v, write_pos,
           block_tables, paged_fn):
    h = basic.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a = attn_mod.attention(lp["attn"], h, cfg=cfg, positions=positions,
                           is_global=is_global, pool_k=pool_k, pool_v=pool_v,
                           write_pos=write_pos, block_tables=block_tables,
                           paged_fn=paged_fn)
    if cfg.post_norms:
        a = basic.rmsnorm(lp["post_ln1"], a, cfg.norm_eps)
    x = x + a
    h = basic.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    f = basic.mlp(lp["ffn"], h, cfg.act)
    if cfg.post_norms:
        f = basic.rmsnorm(lp["post_ln2"], f, cfg.norm_eps)
    return x + f


def _last_pos_head(x):
    """Only the final position is unembedded, so a fused decode step can
    argmax ``[B, 1, V] -> [B]`` on the device."""
    return x[:, -1:, :] if x.shape[1] > 1 else x


def lm_apply(params, cfg, *, tokens, cache, write_pos, block_tables,
             paged_fn=None):
    """Run the trunk over the paged pool (updated in place).

    tokens        [B,S] int (S == 1 decode, or a chunked-prefill chunk)
    cache         the pool from ``init_paged_decode_cache``
    write_pos     [B] int32 position of each row's first token; negative
                  positions (left pad, inactive rows) write nothing
    block_tables  [B,NB] int32
    Returns f32 logits [B, 1, Vpad] of the last position.
    """
    cdt = getattr(torch, cfg.compute_dtype)
    S = tokens.shape[1]
    x = basic.embed_tokens(params["embed"], tokens, cdt,
                           scale_by_dim=cfg.scale_embeds)
    positions = write_pos[:, None] + torch.arange(
        S, dtype=write_pos.dtype, device=write_pos.device)[None]
    for i, lp in enumerate(params["layers"]):
        x = _layer(x, lp, cfg=cfg, positions=positions,
                   is_global=cfg.layer_is_global(i), pool_k=cache["k"][i],
                   pool_v=cache["v"][i], write_pos=write_pos,
                   block_tables=block_tables, paged_fn=paged_fn)
    x = basic.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    x = _last_pos_head(x)
    return basic.unembed(params["embed"], x, cdt, cfg.logit_softcap,
                         vocab=cfg.vocab_size)
