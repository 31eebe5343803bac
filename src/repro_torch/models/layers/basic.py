"""Norms, activations, rotary embeddings, token embeddings, MLPs: plain
functions on tensors, ported from ``repro.models.layers.basic``.

Parameters are plain dicts of tensors with the JAX package's names and
layouts, so ``models.convert.params_from_jax`` maps one onto the other.
Matrices are held in the compute dtype (JAX casts them at every use; the
port casts once); norm scales and biases stay f32 because JAX computes
the norms in f32.  ``uniform``/``normal`` draw the seeded on-device
initialisation from a ``torch.Generator``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def softcap(x, cap):
    return cap * torch.tanh(x / cap)


def rmsnorm(p, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["scale"])).to(dt)


def layernorm(p, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dt)


def groupnorm_heads(p, x, n_heads, eps=1e-5):
    """Per-head group norm of the RWKV wkv output.  x [..., H*hd]."""
    dt = x.dtype
    shp = x.shape
    x = x.reshape(shp[:-1] + (n_heads, shp[-1] // n_heads)).float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = ((x - mu) * torch.rsqrt(var + eps)).reshape(shp)
    return (y * p["scale"] + p["bias"]).to(dt)


def init_rmsnorm(d, device):
    return {"scale": torch.zeros(d, device=device)}


def init_layernorm(d, device):
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def uniform(gen, shape, lim, device, dtype=torch.float32):
    """U(-lim, lim) drawn in f32 from ``gen`` (``jax.random.uniform``'s
    law), then stored in ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(-lim, lim, generator=gen).to(dtype)


def normal(gen, shape, std, device, dtype=torch.float32):
    """N(0, std^2) drawn in f32 from ``gen``, then stored in ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.normal_(generator=gen).mul_(std).to(dtype)


def rope_tables(positions, dim, theta):
    """positions [..., S] -> (sin, cos) [..., S, dim/2] in f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """Split-half rotary embedding.  x [B,S,H,D]; sin/cos [B,S,D/2]."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    sin = sin[..., None, :]                       # add the head axis
    cos = cos[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_tokens(p, tokens, cdt, scale_by_dim=False):
    tab = p["table"].to(cdt)
    x = tab[tokens]
    if scale_by_dim:
        x = x * torch.tensor(tab.shape[-1] ** 0.5, dtype=cdt)
    return x


def unembed(p, x, cdt, logit_cap=None, vocab=None):
    """x [B,S,D] -> f32 logits [B,S,Vpad] through ``p["unembed"]`` [D,Vpad]
    where the model has one (untied), else the tied table, with the final
    softcap and the padded-vocab columns masked to -1e9 (so softmax and
    argmax never pick them)."""
    if "unembed" in p:
        logits = torch.matmul(x, p["unembed"].to(cdt)).float()
    else:
        logits = torch.matmul(x, p["table"].to(cdt).t()).float()
    if logit_cap:
        logits = softcap(logits, logit_cap)
    vpad = logits.shape[-1]
    if vocab is not None and vocab != vpad:
        col = torch.arange(vpad, device=logits.device)
        logits = torch.where(col < vocab, logits, -1e9)
    return logits


def mlp(p, x, act="silu"):
    """Gated MLP: act(x @ w_gate) * (x @ w_up) @ w_down."""
    cdt = x.dtype
    g = torch.matmul(x, p["w_gate"].to(cdt))
    u = torch.matmul(x, p["w_up"].to(cdt))
    return torch.matmul(act_fn(act)(g) * u, p["w_down"].to(cdt))
