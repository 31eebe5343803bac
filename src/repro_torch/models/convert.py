"""Parameter trees: the JAX tree -> the port's parameters, so both
packages compute the same function in the tests (numpy arrays only; the
caller does ``jax.device_get``, this module never imports JAX), and a
port tree moved to another device."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as lm_mod

# leaves the reference uses in f32 whatever their rank: the SSM's decay
# log (``-exp(a_log)`` with no cast) and RWKV's bonus (f32 on its scan
# path; the kernel path rounds it at the use)
F32_LEAVES = frozenset({"a_log", "u_bonus"})


def params_from_jax(tree, cfg, device, dtype=None):
    """``tree`` is ``init_lm``'s pytree as numpy arrays: ``embed`` (with
    ``unembed`` when untied), ``ln_f``, ``ln0`` (rwkv6), ``meta`` (hymba),
    ``pre_layers`` (empty for these families) and ``layers`` with every
    leaf stacked on a leading ``[L]`` axis.  Each leaf keeps the dtype the
    reference uses it in: matrices land in ``dtype`` (default: the compute
    dtype, the reference casts them at every use), 1-D leaves and
    ``F32_LEAVES`` in f32."""
    lm_mod.check_supported(cfg)
    if tree.get("pre_layers"):
        raise NotImplementedError("unstacked leading layers are not ported")
    dtype = dtype or getattr(torch, cfg.compute_dtype)

    def conv(name, a):
        a = np.asarray(a, np.float32)
        t = torch.from_numpy(a.copy()).to(device)
        return t if a.ndim <= 1 or name in F32_LEAVES else t.to(dtype)

    def walk(node, name=None, i=None):
        if isinstance(node, dict):
            return {k: walk(v, k, i) for k, v in node.items()}
        return conv(name, node if i is None else np.asarray(node)[i])

    out = {k: walk(v, k) for k, v in tree.items()
           if k not in ("pre_layers", "layers")}
    out["layers"] = [walk(tree["layers"], i=i) for i in range(cfg.n_layers)]
    return out


def params_to(tree, device=None, dtype=None):
    """The port's parameter tree (nested dicts and lists of tensors) on
    ``device`` and, where ``dtype`` is given, every leaf cast to it."""
    if isinstance(tree, dict):
        return {k: params_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)
