"""RWKV6 (Finch) time-mix and channel-mix, ported from
``repro.models.layers.rwkv``.

Per head (dim N) a state S in R^{N x N}:
  y_t = r_t . (S_t + diag(u) k_t v_t^T)          (read)
  S_{t+1} = diag(w_t) S_t + k_t v_t^T            (update; w_t data-dependent)
Token shift is the v6 "ddlerp" (a LoRA-modulated lerp with x_{t-1}).

* **Train mode** (no state in, none needed) starts every row from a zero
  state and never reads the final one, so the recurrence runs through
  ``kernels.ops.wkv6`` (the CUDA kernel on the card, its plain version on
  the CPU) with ``u`` rounded to r's dtype, as the reference's Pallas path
  rounds it.  Its gradient is ``Wkv6Fn``'s (the backward kernel on the
  card); ``u``'s comes back through the rounding, in f32.  In bf16 this
  differs by design from the reference's training scan, which keeps ``u``
  in f32; in f32 the two are one function.
* **Prefill and decode** carry the state: the token shifts come from the
  state and the recurrence runs the reference's scan
  (``kernels.ref.wkv6_carry``, a plain f32 time loop) with ``u`` in f32.
  The new token shifts are stored in bf16 whatever the compute dtype, as
  the reference stores them.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models.layers.basic import (groupnorm_heads, init_layernorm,
                                             uniform)

TM_TARGETS = ("r", "k", "v", "w", "g")


def init_rwkv_tmix(gen, cfg, device, dtype):
    """``init_rwkv_tmix``'s distributions, drawn from ``gen``: matrices in
    ``dtype``; ``u_bonus`` and the 1-D leaves in f32 (the reference uses
    them in f32 or rounds them at the use)."""
    d, r = cfg.d_model, cfg.rwkv
    lim = d ** -0.5
    H = d // r.head_dim
    n = len(TM_TARGETS)

    def mat(shape, lim):
        return uniform(gen, shape, lim, device, dtype)
    return {
        "mu": torch.full((n, d), 0.5, device=device).to(dtype),
        "mix_a": mat((d, n * r.mix_lora), lim),
        "mix_b": mat((n, r.mix_lora, d), r.mix_lora ** -0.5),
        "wr": mat((d, d), lim), "wk": mat((d, d), lim),
        "wv": mat((d, d), lim), "wg": mat((d, d), lim),
        "wo": mat((d, d), lim),
        "w_base": torch.full((d,), -6.0, device=device),
        "w_lora_a": mat((d, r.decay_lora), lim),
        "w_lora_b": mat((r.decay_lora, d), r.decay_lora ** -0.5),
        "u_bonus": uniform(gen, (H, r.head_dim), 1.0, device),
        "gn": init_layernorm(d, device),
    }


def init_rwkv_cmix(gen, cfg, device, dtype):
    d, f = cfg.d_model, cfg.d_ff
    lim = d ** -0.5
    return {
        "mu_k": torch.full((d,), 0.5, device=device),
        "mu_r": torch.full((d,), 0.5, device=device),
        "wk": uniform(gen, (d, f), lim, device, dtype),
        "wv": uniform(gen, (f, d), f ** -0.5, device, dtype),
        "wr": uniform(gen, (d, d), lim, device, dtype),
    }


def _shifted(x, prev=None):
    """x_{t-1} [B,S,D]: the row before the first token is ``prev`` [B,D]
    (a carried token shift) or zero."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p, x, x_prev):
    """v6 data-dependent token shift -> dict of mixed inputs per target."""
    cdt = x.dtype
    dx = x_prev - x
    # low-rank modulation trunk (v6 "ddlerp": shared half-mix input)
    a = torch.tanh(torch.matmul(x + dx * 0.5, p["mix_a"].to(cdt)))
    a = a.reshape(a.shape[:-1] + (len(TM_TARGETS), -1))
    mods = torch.einsum("bstr,trd->tbsd", a, p["mix_b"].to(cdt))
    return {t: x + dx * (p["mu"][i].to(cdt) + mods[i])
            for i, t in enumerate(TM_TARGETS)}


def rwkv_time_mix(p, x, cfg, state=None, need_state=False, wkv_fn=None):
    """x [B,S,D] -> (out [B,S,D], new state).

    ``state`` {'shift': [B,D], 'wkv': [B,H,N,N] f32} or None (a zero
    start).  With no state and ``need_state`` False (train) the recurrence
    is ``wkv_fn`` (default ``kernels.ops.wkv6``; a check can pass its plain
    version to compare the kernel inside the model) and the new state is
    None; otherwise it is the carried scan and the new state is
    ``{'shift': x[:, -1] in bf16, 'wkv': sT}``."""
    cdt = x.dtype
    B, S, D = x.shape
    N = cfg.rwkv.head_dim
    H = D // N
    mixed = _ddlerp(p, x, _shifted(x, None if state is None
                                   else state["shift"]))

    def proj(name, t):
        return torch.matmul(mixed[t], p[name].to(cdt))
    r = proj("wr", "r").reshape(B, S, H, N)
    k = proj("wk", "k").reshape(B, S, H, N)
    v = proj("wv", "v").reshape(B, S, H, N)
    g = F.silu(proj("wg", "g"))
    w_log = p["w_base"].to(cdt) + torch.matmul(
        torch.matmul(mixed["w"], p["w_lora_a"].to(cdt)),
        p["w_lora_b"].to(cdt))
    w = torch.exp(-torch.exp(w_log.float())).reshape(B, S, H, N)
    new_state = None
    if state is None and not need_state:
        y = (wkv_fn or functools.partial(kops.wkv6, tuned=True))(
            r, k, v, w, p["u_bonus"].to(r.dtype))
    else:
        s0 = (state["wkv"] if state is not None else
              torch.zeros((B, H, N, N), dtype=torch.float32,
                          device=x.device))
        y, sT = ref.wkv6_carry(r, k, v, w, p["u_bonus"].float(), s0)
        new_state = {"shift": x[:, -1].to(torch.bfloat16), "wkv": sT}
    y = groupnorm_heads(p["gn"], y.to(cdt).reshape(B, S, D), H) * g
    return torch.matmul(y, p["wo"].to(cdt)), new_state


def rwkv_channel_mix(p, x, cfg, state=None):
    """x [B,S,D] -> (out [B,S,D], new shift [B,D] bf16): squared-ReLU FFN
    on the token-shifted input (the row before the first token is
    ``state``, a carried shift, or zero), gated by a sigmoid receptance."""
    cdt = x.dtype
    dx = _shifted(x, state) - x
    xk = x + dx * p["mu_k"].to(cdt)
    xr = x + dx * p["mu_r"].to(cdt)
    k = torch.square(F.relu(torch.matmul(xk, p["wk"].to(cdt))))
    kv = torch.matmul(k, p["wv"].to(cdt))
    out = torch.sigmoid(torch.matmul(xr, p["wr"].to(cdt))) * kv
    return out, x[:, -1].to(torch.bfloat16)


def init_rwkv_state(cfg, batch, n_layers, device):
    """The decode state of ``n_layers`` layers: ``tm_shift``/``cm_shift``
    [L,B,d] bf16 and ``wkv`` [L,B,H,N,N] f32, zeros (as
    ``init_rwkv_state``)."""
    d, N = cfg.d_model, cfg.rwkv.head_dim
    return {
        "tm_shift": torch.zeros((n_layers, batch, d), dtype=torch.bfloat16,
                                device=device),
        "cm_shift": torch.zeros((n_layers, batch, d), dtype=torch.bfloat16,
                                device=device),
        "wkv": torch.zeros((n_layers, batch, d // N, N, N),
                           dtype=torch.float32, device=device),
    }
