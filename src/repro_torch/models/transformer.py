"""Decoder-only LM trunk: a port of ``repro.models.transformer``.

* the dense family: the train-mode forward (``mode="train"``: logits of
  every position, each layer's attention through the flash kernel and,
  under autograd, its backward kernel; ``remat`` recomputes each layer in
  the backward pass), and the prefill and decode modes, over the dense
  slot cache or the paged KV pool;
* the ``ssm`` (rwkv6) and ``hybrid`` (hymba) families: the train-mode
  forward (``mode="train"``: logits of every position, from a zero
  recurrent state), the path on which the reference runs its ``wkv6`` and
  ``ssm_scan`` kernels; and prefill and decode, which carry the recurrent
  state (token shifts and WKV state; conv buffer and SSM state) through
  the reference's scans.  hymba's prefill prepends its meta tokens, so
  its first decoded token sits at position ``meta_tokens + S``; its
  decode writes K/V into the dense slot cache.  The paged pool refuses
  both families, as the reference's does.

The layers run as a Python loop over per-layer parameter dicts, so each
layer's local/global flag (``cfg.layer_is_global(i)``) is a plain bool.
Other families (moe, mla, encoder-decoder), modality frontends and padded
heads raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import basic
from repro_torch.models.layers import mamba as mamba_mod
from repro_torch.models.layers import rwkv as rwkv_mod


def is_recurrent(cfg) -> bool:
    """rwkv6 (ssm) and hymba (hybrid): rows carry recurrent state."""
    return ((cfg.family == "ssm" and cfg.rwkv and cfg.attn_impl == "none")
            or (cfg.family == "hybrid" and cfg.ssm
                and cfg.attn_impl == "gqa"))


def supported_modes(cfg) -> tuple:
    """The modes of ``lm_apply`` the port runs for ``cfg``."""
    if (cfg.moe or cfg.mla or cfg.encdec or cfg.frontend is not None
            or cfg.n_prefix_embeds or cfg.padded_heads != cfg.n_heads):
        return ()
    if (cfg.family == "dense" and cfg.attn_impl == "gqa" and not cfg.ssm
            and not cfg.rwkv and not cfg.meta_tokens):
        return ("train", "prefill", "decode")
    if is_recurrent(cfg):
        return ("train", "prefill", "decode")
    return ()


def check_supported(cfg, mode=None) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``cfg`` in
    ``mode`` (in some mode, when ``mode`` is None)."""
    modes = supported_modes(cfg)
    if not modes or (mode is not None and mode not in modes):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense GQA decoders, rwkv6 (ssm) "
            "and hymba (hybrid) in train, prefill and decode; not "
            f"{cfg.family} in {mode or 'any'} mode (no moe, "
            "mla, encoder-decoder, frontends or padded heads yet)")


def init_decode_cache(cfg, batch, max_len, device):
    """The decode cache, one flat dict with the reference's keys, every
    leaf ``[L, batch, ...]``: the dense slot cache ``{'k','v': [L, batch,
    max_len, KH, hd]}`` in bf16 (``attention.init_kv_cache``) for the
    attention stacks (dense, hymba); hymba's ``conv``/``h``
    (``mamba.init_mamba_state``); rwkv6's ``tm_shift``/``cm_shift``/``wkv``
    (``rwkv.init_rwkv_state``) alone."""
    check_supported(cfg, "decode")
    L = cfg.n_layers
    c = {}
    if cfg.attn_impl == "gqa":
        c.update(attn_mod.init_kv_cache(cfg, batch, max_len, L, device))
    if cfg.family == "hybrid":
        c.update(mamba_mod.init_mamba_state(cfg, batch, L, device))
    if cfg.family == "ssm":
        c.update(rwkv_mod.init_rwkv_state(cfg, batch, L, device))
    return c


def init_paged_decode_cache(cfg, n_blocks, block_size, device):
    """The paged pool, one per layer: ``{'k','v': [L, n_blocks + 1, bs, KH,
    hd]}`` in bf16 whatever the compute dtype (as the JAX pool).  Page
    ``n_blocks`` of each layer is a trash page that takes the writes JAX
    drops (``attention.paged_write``); pages ``[0, n_blocks)`` are the
    pool proper.  Only plain GQA stacks page: the recurrent families carry
    per-row state that is not positional, and hymba's meta tokens come
    from a prefill the chunked path never runs, so both raise, as in the
    reference."""
    check_supported(cfg, "decode")
    if is_recurrent(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the paged KV cache needs a plain GQA attention "
            "stack (no recurrent state or meta tokens)")
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
    return _residual_mlp(x, a, lp, cfg), new_kv


def _residual_mlp(x, a, lp, cfg):
    """The attention output ``a`` (post-normed where the model has post
    norms) added to ``x``, then the gated-MLP block with its residual."""
    if cfg.post_norms:
        a = basic.rmsnorm(lp["post_ln1"], a, cfg.norm_eps)
    x = x + a
    f = basic.mlp(lp["ffn"], basic.rmsnorm(lp["ln2"], x, cfg.norm_eps),
                  cfg.act)
    if cfg.post_norms:
        f = basic.rmsnorm(lp["post_ln2"], f, cfg.norm_eps)
    return x + f


def _ssm_layer(x, lp, *, cfg, state, need_state, wkv_fn):
    """One rwkv6 layer: time mix and channel mix, each on a layernormed
    input (eps 1e-5, the reference's default there) with a residual.
    ``state``: the layer's ``tm_shift``/``wkv``/``cm_shift`` or None.
    Returns (x, the layer's new state or None)."""
    tm_state = (None if state is None else
                {"shift": state["tm_shift"], "wkv": state["wkv"]})
    h, tm_new = rwkv_mod.rwkv_time_mix(
        lp["tmix"], basic.layernorm(lp["ln1"], x), cfg, tm_state,
        need_state=need_state, wkv_fn=wkv_fn)
    x = x + h
    h, cm_new = rwkv_mod.rwkv_channel_mix(
        lp["cmix"], basic.layernorm(lp["ln2"], x), cfg,
        None if state is None else state["cm_shift"])
    new = (None if tm_new is None else
           {"tm_shift": tm_new["shift"], "wkv": tm_new["wkv"],
            "cm_shift": cm_new})
    return x + h, new


def _hybrid_layer(x, lp, *, cfg, positions, is_global, cache, write_pos,
                  need_state, ssm_fn):
    """One hymba layer: attention heads and SSM heads in parallel on the
    same normed input, each path RMS-normed and the two averaged before
    the shared ``wo``; then the gated MLP.  ``cache``: the layer's
    ``k``/``v`` slot stripes (written in place) and ``conv``/``h``, or
    None; the attention reads the first two, the mixer the last two.
    Returns (x, the prefill's K/V and the new SSM state, as present)."""
    cdt = x.dtype
    h = basic.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a_pre, new_kv = attn_mod.attention(
        lp["attn"], h, cfg=cfg, positions=positions, is_global=is_global,
        cache=cache, write_pos=write_pos, pre_output=True)
    s_out, s_new = mamba_mod.mamba_mixer(lp["mamba"], h, cfg, cache,
                                         need_state=need_state, ssm_fn=ssm_fn)
    real = cfg.n_heads * cfg.head_dim
    fused = 0.5 * (basic.rmsnorm(lp["norm_attn"], a_pre[..., :real],
                                 cfg.norm_eps)
                   + basic.rmsnorm(lp["norm_ssm"], s_out, cfg.norm_eps))
    wo = lp["attn"]["wo"].to(cdt)[:cfg.n_heads].reshape(real, cfg.d_model)
    return (_residual_mlp(x, torch.matmul(fused, wo), lp, cfg),
            {**(new_kv or {}), **(s_new or {})})


def _recurrent_layer(x, lp, *, cfg, positions, is_global, cache, write_pos,
                     need_state, wkv_fn, ssm_fn):
    """One rwkv6 (``_ssm_layer``) or hymba (``_hybrid_layer``) layer:
    (x, the layer's new state or None)."""
    if cfg.family == "ssm":
        return _ssm_layer(x, lp, cfg=cfg, state=cache, need_state=need_state,
                          wkv_fn=wkv_fn)
    return _hybrid_layer(x, lp, cfg=cfg, positions=positions,
                         is_global=is_global, cache=cache,
                         write_pos=write_pos, need_state=need_state,
                         ssm_fn=ssm_fn)


def _output(layer, x, lp):
    """``layer``'s output alone (a train layer's new state is None)."""
    return layer(x, lp)[0]


def _recurrent_apply(params, cfg, tokens, mode, cache, write_pos, max_len,
                     wkv_fn, ssm_fn, remat):
    """``lm_apply`` for rwkv6 and hymba.  Train and prefill run from zero
    state at positions ``0..St-1``, hymba's meta tokens prepended (rwkv6's
    ``ln0`` after the embedding), the prefix sliced off after the final
    norm; train with ``remat`` runs each layer under
    ``torch.utils.checkpoint`` (non-reentrant), as the dense stack does;
    decode prepends nothing, runs at ``write_pos`` and writes every
    layer's new state into ``cache`` in place (hymba's K/V through the
    attention's slot write)."""
    cdt = getattr(torch, cfg.compute_dtype)
    B, S = tokens.shape
    x = basic.embed_tokens(params["embed"], tokens, cdt,
                           scale_by_dim=cfg.scale_embeds)
    if cfg.family == "ssm":
        x = basic.layernorm(params["ln0"], x)
    n_meta = cfg.meta_tokens if mode != "decode" else 0
    if n_meta:
        meta = params["meta"].to(cdt).expand(B, n_meta, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
    St = x.shape[1]
    if mode == "decode":
        positions = write_pos[:, None] + torch.arange(
            St, dtype=write_pos.dtype, device=write_pos.device)[None]
    else:
        positions = torch.arange(St, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, St)
    if mode == "prefill":
        max_len = max_len or St
        if max_len < St:
            raise ValueError(f"max_len={max_len} < prefix + prompt length "
                             f"{St}")
    new = []
    for i, lp in enumerate(params["layers"]):
        layer_cache = ({key: c[i] for key, c in cache.items()}
                       if mode == "decode" else None)
        layer = functools.partial(
            _recurrent_layer, cfg=cfg, positions=positions,
            is_global=cfg.layer_is_global(i), cache=layer_cache,
            write_pos=write_pos, need_state=mode != "train", wkv_fn=wkv_fn,
            ssm_fn=ssm_fn)
        if mode == "train":
            x = (checkpoint(_output, layer, x, lp, use_reentrant=False)
                 if remat else _output(layer, x, lp))
            continue
        x, nc = layer(x, lp)
        if mode == "decode":
            for key, t in nc.items():
                layer_cache[key].copy_(t)
        elif mode == "prefill":
            new.append(_prefill_pad_cache(nc, max_len))
    norm = basic.layernorm if cfg.family == "ssm" else basic.rmsnorm
    x = norm(params["ln_f"], x, cfg.norm_eps)
    if n_meta:
        x = x[:, n_meta:]
    if mode != "train":
        x = _last_pos_head(x)
    logits = basic.unembed(params["embed"], x, cdt, cfg.logit_softcap,
                           vocab=cfg.vocab_size)
    if mode == "prefill":
        cache = {key: torch.stack([c[key] for c in new]) for key in new[0]}
    return logits, cache


def _prefill_pad_cache(layer, max_len):
    """One layer's prefill cache: its K/V ``[B, S, KH, hd]`` cast to bf16
    (the cache storage dtype) and zero-padded to ``max_len`` slots; the
    recurrent state leaves pass through as they are."""
    def pad(c):
        return F.pad(c.to(torch.bfloat16),
                     (0, 0, 0, 0, 0, max_len - c.shape[1]))
    return {key: pad(c) if key in ("k", "v") else c
            for key, c in layer.items()}


def _last_pos_head(x):
    """Only the final position is unembedded, so a fused decode step can
    argmax ``[B, 1, V] -> [B]`` on the device."""
    return x[:, -1:, :] if x.shape[1] > 1 else x


def _train_layer(x, lp, *, cfg, positions, is_global, flash_fn):
    """One dense layer of the train-mode forward (no cache)."""
    return _layer(x, lp, cfg=cfg, positions=positions, is_global=is_global,
                  cache=None, write_pos=None, block_tables=None,
                  paged_fn=None, flash_fn=flash_fn)[0]


def lm_apply(params, cfg, *, tokens, mode, cache=None, write_pos=None,
             block_tables=None, max_len=None, paged_fn=None, flash_fn=None,
             wkv_fn=None, ssm_fn=None, remat=True):
    """Run the trunk.

    tokens        [B,S] int
    mode          "train": the forward of every position (rwkv6 and hymba
                  from zero recurrent state); returns (f32 logits
                  [B, S, Vpad], None).  ``wkv_fn``/``ssm_fn`` replace the
                  recurrences' kernels and ``flash_fn`` the dense
                  attention's (a check passes their plain versions).  With
                  ``remat`` and grad mode on, each dense layer runs under
                  ``torch.utils.checkpoint`` (non-reentrant), the
                  counterpart of the reference's ``jax.checkpoint`` with
                  ``nothing_saveable``: its forward runs again in the
                  backward pass, so the attention's (rwkv6's and hymba's
                  recurrence's) forward kernel launches twice a layer and
                  its backward once;
                  ``remat_policy="save_attn"`` is not ported and raises.
                  "prefill": the uncached forward from position 0; returns
                  the new cache (``init_decode_cache``'s keys): K/V [L, B,
                  max_len, KH, hd] in bf16, zero-padded (``max_len``
                  defaults to the prompt length, hymba's meta tokens
                  included), and the recurrent state after the prompt.
                  "decode": S new tokens per row at ``write_pos`` (S == 1,
                  or a chunked-prefill chunk on the paged pool); ``cache``
                  (the slot cache with any recurrent state, or with
                  ``block_tables`` the paged pool) is updated in place and
                  returned.
    write_pos     [B] int32 position of each row's first token (decode);
                  negative positions (left pad, inactive rows) write
                  nothing into the paged pool
    block_tables  [B,NB] int32 (paged pool only)
    Returns (f32 logits [B, 1, Vpad] of the last position, cache) in
    prefill and decode.
    """
    check_supported(cfg, mode)
    remat = remat and mode == "train" and torch.is_grad_enabled()
    if remat and cfg.remat_policy != "nothing":
        raise NotImplementedError(
            f"{cfg.name}: remat_policy={cfg.remat_policy!r} is not ported "
            "(the port recomputes every layer: 'nothing')")
    if is_recurrent(cfg):
        if block_tables is not None:
            raise NotImplementedError(
                f"{cfg.name}: paged decode needs a plain GQA stack")
        return _recurrent_apply(params, cfg, tokens, mode, cache, write_pos,
                                max_len, wkv_fn, ssm_fn, remat)
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
        if mode == "train":
            layer = functools.partial(
                _train_layer, cfg=cfg, positions=positions,
                is_global=cfg.layer_is_global(i), flash_fn=flash_fn)
            x = (checkpoint(layer, x, lp, use_reentrant=False) if remat
                 else layer(x, lp))
            continue
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
    if mode != "train":
        x = _last_pos_head(x)
    logits = basic.unembed(params["embed"], x, cdt, cfg.logit_softcap,
                           vocab=cfg.vocab_size)
    if mode == "prefill":
        cache = {key: torch.stack([c[key] for c in new]) for key in ("k", "v")}
    return logits, cache
