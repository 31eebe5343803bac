"""The train and eval steps, ported from ``repro.train.step``.

``make_train_step`` builds ``(params, opt_state, batch) -> (params,
opt_state, metrics)``: gradient accumulation over ``accum`` micro-batches
(each micro-batch's ``torch.autograd.grad`` summed in f32, then divided by
``accum``), global-norm clipping and the configured optimizer
(``train.optim``).  Unlike the reference's pure step it updates the params
(and the optimizer's moments) in place under ``torch.no_grad()`` and
returns the same trees: at full width a second copy would not fit on one
card.  ``batch_axes`` belongs to the mesh, which the port does not have
yet (ROADMAP queue 1), so there is no such argument.

Every family the port evaluates trains: the dense family through
``FlashAttentionFn``, rwkv6 and hymba through ``Wkv6Fn`` and
``SsmScanFn`` (the recurrences' backward kernels on the card, their plain
versions on the CPU), where the reference takes ``jax.grad`` of its scans.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import check_supported
from repro_torch.train.tree import leaves, unflatten


def accum_steps_for(cfg, global_batch: int, n_batch_shards: int,
                    n_pods: int = 1) -> int:
    """Gradient-accumulation steps.  cfg.microbatch is per-data-shard rows
    at one pod; with more pods the per-shard microbatch shrinks so the
    global microbatch (and per-device activation footprint) stays
    constant."""
    per_shard = max(1, cfg.microbatch // max(n_pods, 1))
    micro_global = per_shard * n_batch_shards
    if global_batch % micro_global == 0 and global_batch >= micro_global:
        return global_batch // micro_global
    return 1


def _to_device(model, batch):
    """``tokens`` and ``labels`` [B,S] (numpy arrays or tensors) on the
    model's device (a no-op for tensors already there)."""
    return {k: torch.as_tensor(batch[k], device=model.device)
            for k in ("tokens", "labels")}


def make_train_step(model, optimizer, accum: int):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {'loss', 'grad_norm', 'lr'})``, metrics as 0-d tensors.  With
    ``cfg.cast_params_once`` the f32 leaves of ndim >= 2 are cast to the
    compute dtype once a step and the gradient is taken at the cast
    copies (the gradient of the cast is the cast of the gradient), as
    the reference hoists its casts above the accumulation loop."""
    cfg = model.cfg
    check_supported(cfg, "train")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    cdt = getattr(torch, cfg.compute_dtype)

    def cast(p):
        return p.to(cdt) if p.dtype == torch.float32 and p.dim() >= 2 else p

    def train_step(params, opt_state, batch):
        batch = _to_device(model, batch)
        rows = batch["tokens"].shape[0]
        if rows % accum:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{accum} micro-batches")
        mb = rows // accum
        flat = leaves(params)
        with torch.no_grad():
            src = [cast(p) for p in flat] if cfg.cast_params_once else flat
        gsum, lsum = None, None
        for i in range(accum):
            micro = {k: t[i * mb:(i + 1) * mb] for k, t in batch.items()}
            xs = [t.detach().requires_grad_() for t in src]
            with torch.enable_grad():
                loss, _ = model.loss(unflatten(params, xs), micro)
                grads = torch.autograd.grad(loss, xs, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for g, x in zip(grads, xs)]
            if gsum is None:
                gsum = [g.float() for g in grads]
                lsum = loss.detach()
            else:
                for s, g in zip(gsum, grads):
                    s.add_(g)
                lsum = lsum + loss.detach()
            del grads, xs
        if accum > 1:
            for g in gsum:
                g.div_(accum)
            lsum = lsum / accum
        grads = unflatten(params, gsum)
        updates, opt_state, ometrics = optimizer.update(grads, opt_state,
                                                        params)
        del grads, gsum
        with torch.no_grad():
            for p, u in zip(flat, leaves(updates)):
                p.add_(u)
        return params, opt_state, {"loss": lsum, **ometrics}

    return train_step


def make_eval_step(model):
    """``eval_step(params, batch) -> {'loss': 0-d tensor}``: the model's
    loss without gradients.  ``batch`` holds ``tokens`` and ``labels``
    [B,S], as numpy arrays or tensors; they are placed on the model's
    device (a no-op for tensors already there, so a caller that moved them
    beforehand keeps the step free of host copies)."""
    def eval_step(params, batch):
        batch = _to_device(model, batch)
        with torch.no_grad():
            loss, _ = model.loss(params, batch)
        return {"loss": loss}
    return eval_step
