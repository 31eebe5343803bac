"""Model API of the port: dense GQA decoders, rwkv6 and hymba (the
train-mode forward and its loss, prefill and decode).

``build_model(cfg, device=None)`` returns a ``Model`` whose members are
plain functions on tensors, with the JAX package's signatures:

  init(seed, dtype=None)                           -> params
  loss(params, batch)                              -> (scalar loss, aux)
  prefill(params, batch, max_len)                  -> (logits [B,Vpad], cache)
  decode(params, cache, tokens, pos, bt=None)      -> (logits [B,Vpad], cache)
  decode_step(params, cache, tokens, pos, bt=None) -> (next tokens [B], cache)
  init_cache(batch, max_len)                       -> the dense slot cache
                                                      and/or recurrent state
  init_paged_cache(n_blocks, block_size)           -> the paged pool

``decode`` runs over the paged pool when given block tables, else over the
dense slot cache (with rwkv6's and hymba's recurrent state); both are
updated in place.  hymba's prefill prepends its meta tokens, so its
decode positions start at ``meta_tokens + S``.  ``init``'s matrices are
stored in the compute dtype unless ``dtype`` says otherwise (training
holds f32 master weights, ``cfg.param_dtype``; the layers cast them at
every use, as the reference does).  ``loss`` is the mean cross entropy
over every position, differentiable for the dense family (its attention
kernel has a backward).  A member whose mode the
family does not run yet (``transformer.supported_modes``) raises
``NotImplementedError`` when called, and so does ``init_paged_cache`` for
the recurrent families.  ``wkv_fn``/``ssm_fn`` (``loss``) reach the
train-mode forward only: prefill and decode carry state through the
reference's scans.

``device=None`` means the card; without CUDA it raises (pass
``device="cpu"`` for the plain versions on the host).

``count_params(cfg)`` counts a config's parameters from their shapes (built
on the ``meta`` device), for the cost model's analytic censuses.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.models import transformer as lm_mod
from repro_torch.models.layers import basic
from repro_torch.models.layers import mamba as mamba_mod
from repro_torch.models.layers import rwkv as rwkv_mod


def fused_decode_step(decode):
    """Greedy argmax over the last-position logits, inside the step, so a
    caller moves ``[B]`` tokens instead of ``[B, vocab]`` logits.  Padded
    vocab columns are already at -1e9; argmax takes the first maximum, as
    ``jnp.argmax`` does."""
    def decode_step(params, cache, tokens, pos, block_tables=None, **kw):
        logits, cache = decode(params, cache, tokens, pos, block_tables, **kw)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return decode_step


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelCfg
    device: torch.device
    init: Callable
    prefill: Callable
    decode: Callable
    decode_step: Callable
    init_cache: Callable
    init_paged_cache: Callable
    loss: Callable


def cross_entropy(logits, labels, mask=None):
    """logits [B,S,V] (f32), labels [B,S] -> mean nll over the unmasked
    tokens."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _init_attention(gen, cfg, device, dtype):
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {k: basic.uniform(gen, shape, lim, device, dtype)
         for k, shape, lim in (("wq", (d, H, hd), d ** -0.5),
                               ("wk", (d, KH, hd), d ** -0.5),
                               ("wv", (d, KH, hd), d ** -0.5),
                               ("wo", (H, hd, d), (H * hd) ** -0.5))}
    if cfg.qk_norm:
        p["q_norm"] = basic.init_rmsnorm(hd, device)
        p["k_norm"] = basic.init_rmsnorm(hd, device)
    return p


def _init_mlp(gen, d, f, device, dtype):
    return {k: basic.uniform(gen, shape, lim, device, dtype)
            for k, shape, lim in (("w_gate", (d, f), d ** -0.5),
                                  ("w_up", (d, f), d ** -0.5),
                                  ("w_down", (f, d), f ** -0.5))}


def _init_layer(gen, cfg, device, dtype):
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln1": basic.init_layernorm(d, device),
                "tmix": rwkv_mod.init_rwkv_tmix(gen, cfg, device, dtype),
                "ln2": basic.init_layernorm(d, device),
                "cmix": rwkv_mod.init_rwkv_cmix(gen, cfg, device, dtype)}
    lp = {"ln1": basic.init_rmsnorm(d, device),
          "ln2": basic.init_rmsnorm(d, device),
          "attn": _init_attention(gen, cfg, device, dtype)}
    if cfg.family == "hybrid":
        lp["mamba"] = mamba_mod.init_mamba(gen, cfg, device, dtype)
        lp["norm_attn"] = basic.init_rmsnorm(cfg.n_heads * cfg.head_dim,
                                             device)
        lp["norm_ssm"] = basic.init_rmsnorm(d, device)
    lp["ffn"] = _init_mlp(gen, d, cfg.d_ff, device, dtype)
    if cfg.post_norms:
        lp["post_ln1"] = basic.init_rmsnorm(d, device)
        lp["post_ln2"] = basic.init_rmsnorm(d, device)
    return lp


def init_params(cfg, seed, device, dtype=None):
    """Seeded random parameters with ``init_lm``'s distributions (uniform
    +-fan_in^-0.5 projections, normal * 0.02 embedding, unembedding and
    meta tokens, the norms' and recurrences' constants), drawn in f32 on
    ``device`` one tensor at a time from a ``torch.Generator``.  Matrices
    are then stored in ``dtype`` (default the compute dtype; JAX casts
    them at every use); 1-D leaves and the leaves the reference uses in
    f32 (``a_log``, ``u_bonus``) stay f32."""
    lm_mod.check_supported(cfg)
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    # on ``meta`` (shapes only, see ``count_params``) nothing is drawn and
    # a meta generator does not exist: a CPU one stands in
    device = torch.device(device)
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(int(seed))
    d, vpad = cfg.d_model, cfg.padded_vocab
    ssm = cfg.family == "ssm"
    embed = {"table": basic.normal(gen, (vpad, d), 0.02, device, dtype)}
    if not cfg.tie_embeddings:
        embed["unembed"] = basic.normal(gen, (d, vpad), 0.02, device, dtype)
    norm = basic.init_layernorm if ssm else basic.init_rmsnorm
    params = {"embed": embed, "ln_f": norm(d, device)}
    if ssm:
        params["ln0"] = basic.init_layernorm(d, device)
    if cfg.meta_tokens:
        params["meta"] = basic.normal(gen, (cfg.meta_tokens, d), 0.02,
                                      device, dtype)
    params["layers"] = [_init_layer(gen, cfg, device, dtype)
                        for _ in range(cfg.n_layers)]
    return params


def build_model(cfg: ModelCfg, device=None) -> Model:
    lm_mod.check_supported(cfg)
    dev = resolve_device(device)

    def init(seed=0, dtype=None):
        return init_params(cfg, seed, dev, dtype)

    def prefill(params, batch, max_len=None, flash_fn=None):
        logits, cache = lm_mod.lm_apply(params, cfg, tokens=batch["tokens"],
                                        mode="prefill", max_len=max_len,
                                        flash_fn=flash_fn)
        return logits[:, -1, :], cache

    def decode(params, cache, tokens, pos, block_tables=None, paged_fn=None):
        logits, cache = lm_mod.lm_apply(params, cfg, tokens=tokens,
                                        mode="decode", cache=cache,
                                        write_pos=pos,
                                        block_tables=block_tables,
                                        paged_fn=paged_fn)
        return logits[:, -1, :], cache

    def init_cache(batch, max_len):
        return lm_mod.init_decode_cache(cfg, batch, max_len, dev)

    def init_paged_cache(n_blocks, block_size):
        return lm_mod.init_paged_decode_cache(cfg, n_blocks, block_size, dev)

    def loss(params, batch, wkv_fn=None, ssm_fn=None):
        """Mean next-token cross entropy of ``batch`` ({'tokens',
        'labels'}: [B,S] int tensors on the model's device) over every
        position of the train-mode forward (``remat`` on, as the
        reference's); ``wkv_fn``/``ssm_fn`` as in ``lm_apply``."""
        logits, _ = lm_mod.lm_apply(params, cfg, tokens=batch["tokens"],
                                    mode="train", wkv_fn=wkv_fn,
                                    ssm_fn=ssm_fn)
        l = cross_entropy(logits, batch["labels"])
        return l, {"ce": l}

    return Model(cfg, dev, init, prefill, decode, fused_decode_step(decode),
                 init_cache, init_paged_cache, loss)


@functools.lru_cache(maxsize=None)
def count_params(cfg: ModelCfg) -> int:
    """Total parameter count, from shapes only: the parameters are built on
    the ``meta`` device, which allocates nothing.  Cached by config (the
    admission gate prices every new prompt length)."""
    params = init_params(cfg, 0, torch.device("meta"))
    return sum(t.numel() for t in tree_leaves(params))


def count_active_params(cfg: ModelCfg) -> int:
    """Active-per-token parameter count: all of them, since every family
    the port builds is dense (``count_params`` refuses MoE configs, whose
    routed experts the JAX package scales by k/E)."""
    return count_params(cfg)
