"""Optimizers on the port's parameter trees: a port of
``repro.train.optim`` (AdamW, factored Adafactor, the warmup-cosine
schedule, global-norm clipping), with the reference's formulas, API and
state keys, so a test compares the two packages' states leaf by leaf.

``Optimizer(init, update)``: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state, {"grad_norm", "lr"})``,
``updates`` to be added to the params.  Every sum is in f32; the step
count and the metrics are 0-d tensors on the params' device, so an update
reads nothing back to the host.  Unlike the reference's pure functions,
``update`` writes the moments into ``state``'s tensors in place and
returns that same state: at full width a second copy of the moments would
not fit beside the model on one card.  Clipping scales each gradient
leaf as the update reaches it, so no clipped copy of the whole tree is
made.  ``torch.optim.AdamW`` orders its weight decay differently and has
no Adafactor, so neither is used.

``state_specs`` (the state's sharding) belongs to the sharding half of
the port, which does not exist yet; ``Optimizer`` has no such member.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.train.tree import leaves, paths, tree_map, unflatten


class Optimizer(NamedTuple):
    init: Callable
    update: Callable        # (grads, state, params)


def warmup_cosine(peak_lr: float, warmup: int = 200, total: int = 10_000,
                  floor: float = 0.1):
    """step (an int tensor or number) -> f32 learning rate: linear warmup
    to ``peak_lr``, then a cosine down to ``floor * peak_lr`` at
    ``total``."""
    def sched(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * torch.clamp(step / warmup, max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return sched


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, in f32 (0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _clip_scale(grads, max_norm):
    gn = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm):
    """(grads scaled so their global norm is at most ``max_norm``, the
    norm before scaling)."""
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


def _prepare(grads, state, clip_norm, lr):
    """The clip scale (None without clipping), the norm, the new count and
    its learning rate."""
    scale, gn = None, torch.zeros((), dtype=torch.float32,
                                  device=state["count"].device)
    if clip_norm is not None:
        scale, gn = _clip_scale(grads, clip_norm)
    c = state["count"] + 1
    return scale, gn, c, lr(c)


def _f32(g, scale):
    g = g.float()
    return g if scale is None else g * scale


def _zeros_like(p, shape=None):
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


def _count(params):
    return torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)


# ---------------------------------------------------------------------------
# AdamW


def make_adamw(lr: Callable, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
               clip_norm: Optional[float] = 1.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros_like, params),
                "v": tree_map(_zeros_like, params), "count": _count(params)}

    def update(grads, state, params):
        scale, gn, c, lr_t = _prepare(grads, state, clip_norm, lr)
        cf = c.float()
        bc1, bc2 = 1 - b1 ** cf, 1 - b2 ** cf

        def upd(g, mm, vv, p):
            g = _f32(g, scale)
            mm.mul_(b1).add_((1 - b1) * g)
            vv.mul_(b2).add_((1 - b2) * torch.square(g))
            step = (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (-lr_t * step).to(p.dtype)
        updates = tree_map(upd, grads, state["m"], state["v"], params)
        state["count"] = c
        return updates, state, {"grad_norm": gn, "lr": lr_t}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)


def make_adafactor(lr: Callable, *, decay=0.8, eps=1e-30, clip_threshold=1.0,
                   min_dim_factored=128, weight_decay=0.0,
                   clip_norm: Optional[float] = 1.0) -> Optimizer:
    def factored(p):
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def slot(p):
        if factored(p):
            return {"vr": _zeros_like(p, p.shape[:-1]),
                    "vc": _zeros_like(p, p.shape[:-2] + p.shape[-1:])}
        return {"v": _zeros_like(p)}

    def init(params):
        return {"slots": tree_map(slot, params), "count": _count(params)}

    def update(grads, state, params):
        scale, gn, c, lr_t = _prepare(grads, state, clip_norm, lr)
        beta = 1.0 - c.float() ** -decay
        slots = state["slots"]
        g_leaves, p_leaves = leaves(grads), leaves(params)
        # a slot is one dict of 1-2 tensors: walk the params' structure
        s_leaves = [_slot_at(slots, path) for path in paths(params)]
        ups = []
        for g, p, s in zip(g_leaves, p_leaves, s_leaves):
            g = _f32(g, scale)
            g2 = torch.square(g) + eps
            if "vr" in s:
                s["vr"].mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-1))
                s["vc"].mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-2))
                vr, vc = s["vr"], s["vc"]
                denom = (vr[..., None] / torch.mean(vr, dim=-1, keepdim=True)
                         [..., None]) * vc[..., None, :]
                pre = g * torch.rsqrt(denom + eps)
            else:
                s["v"].mul_(beta).add_((1 - beta) * g2)
                pre = g * torch.rsqrt(s["v"] + eps)
            rms = torch.sqrt(torch.mean(torch.square(pre)) + 1e-12)
            pre = pre / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                pre = pre + weight_decay * p.float()
            ups.append((-lr_t * pre).to(p.dtype))
        state["count"] = c
        return unflatten(params, ups), state, {"grad_norm": gn, "lr": lr_t}

    return Optimizer(init, update)


def _slot_at(slots, path):
    for key in path:
        slots = slots[key]
    return slots


def make_optimizer(name: str, lr_peak: float = 3e-4, **kw) -> Optimizer:
    sched = warmup_cosine(lr_peak)
    if name == "adamw":
        return make_adamw(sched, **kw)
    if name == "adafactor":
        return make_adafactor(sched, **kw)
    raise ValueError(f"unknown optimizer {name}")
