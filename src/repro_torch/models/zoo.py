"""Model API of the port (dense GQA decoders over the paged KV pool).

``build_model(cfg, device=None)`` returns a ``Model`` whose members are
plain functions on tensors, with the JAX package's signatures:

  init(seed)                                  -> params
  decode(params, cache, tokens, pos, bt)      -> (logits [B,Vpad], cache)
  decode_step(params, cache, tokens, pos, bt) -> (next tokens [B], cache)
  init_paged_cache(n_blocks, block_size)      -> the paged pool

``device=None`` means the card; without CUDA it raises (pass
``device="cpu"`` for the plain versions on the host).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.models import transformer as lm_mod


def fused_decode_step(decode):
    """Greedy argmax over the last-position logits, inside the step, so a
    caller moves ``[B]`` tokens instead of ``[B, vocab]`` logits.  Padded
    vocab columns are already at -1e9; argmax takes the first maximum, as
    ``jnp.argmax`` does."""
    def decode_step(params, cache, tokens, pos, block_tables, **kw):
        logits, cache = decode(params, cache, tokens, pos, block_tables, **kw)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return decode_step


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelCfg
    device: torch.device
    init: Callable
    decode: Callable
    decode_step: Callable
    init_paged_cache: Callable


def _uniform(gen, shape, lim, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(-lim, lim, generator=gen)


def init_params(cfg, seed, device):
    """Seeded random parameters with ``init_lm``'s distributions: uniform
    +-d^-0.5 projections (+-(H*hd)^-0.5 for wo, +-d_ff^-0.5 for w_down),
    normal * 0.02 embedding, zero norm scales.  Drawn in f32 on ``device``
    one tensor at a time; matrices are then stored in the compute dtype
    (JAX casts them at every use), norm scales in f32."""
    lm_mod.check_supported(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d, f, H, KH, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    zeros = lambda n: {"scale": torch.zeros(n, device=device)}  # noqa: E731
    mat = lambda shape, lim: _uniform(gen, shape, lim, device).to(dtype)  # noqa: E731
    table = torch.empty((cfg.padded_vocab, d), device=device)
    table.normal_(generator=gen).mul_(0.02)
    layers = []
    for _ in range(cfg.n_layers):
        lp = {"ln1": zeros(d), "ln2": zeros(d),
              "attn": {"wq": mat((d, H, hd), d ** -0.5),
                       "wk": mat((d, KH, hd), d ** -0.5),
                       "wv": mat((d, KH, hd), d ** -0.5),
                       "wo": mat((H, hd, d), (H * hd) ** -0.5)},
              "ffn": {"w_gate": mat((d, f), d ** -0.5),
                      "w_up": mat((d, f), d ** -0.5),
                      "w_down": mat((f, d), f ** -0.5)}}
        if cfg.post_norms:
            lp["post_ln1"], lp["post_ln2"] = zeros(d), zeros(d)
        layers.append(lp)
    return {"embed": {"table": table.to(dtype)}, "ln_f": zeros(d),
            "layers": layers}


def build_model(cfg: ModelCfg, device=None) -> Model:
    lm_mod.check_supported(cfg)
    dev = resolve_device(device)

    def init(seed=0):
        return init_params(cfg, seed, dev)

    def decode(params, cache, tokens, pos, block_tables, paged_fn=None):
        logits = lm_mod.lm_apply(params, cfg, tokens=tokens, cache=cache,
                                 write_pos=pos, block_tables=block_tables,
                                 paged_fn=paged_fn)
        return logits[:, -1, :], cache

    def init_paged_cache(n_blocks, block_size):
        return lm_mod.init_paged_decode_cache(cfg, n_blocks, block_size, dev)

    return Model(cfg, dev, init, decode, fused_decode_step(decode),
                 init_paged_cache)
