"""Parameter trees: the JAX tree -> the port's parameters, so both
packages compute the same function in the tests (numpy arrays only; the
caller does ``jax.device_get``, this module never imports JAX), and a
port tree moved to another device."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as lm_mod


def params_from_jax(tree, cfg, device, dtype=None):
    """``tree`` is ``init_lm``'s pytree as numpy arrays: ``embed``,
    ``ln_f``, ``pre_layers`` (empty for dense models) and ``layers`` with
    every leaf stacked on a leading ``[L]`` axis.  Matrices land in
    ``dtype`` (default: the compute dtype), norm scales in f32."""
    lm_mod.check_supported(cfg)
    if tree.get("pre_layers"):
        raise NotImplementedError("unstacked leading layers are not ported")
    dtype = dtype or getattr(torch, cfg.compute_dtype)

    def conv(a):
        a = np.asarray(a, np.float32)
        t = torch.from_numpy(a.copy()).to(device)
        return t if a.ndim <= 1 else t.to(dtype)

    def walk(node, i=None):
        if isinstance(node, dict):
            return {k: walk(v, i) for k, v in node.items()}
        return conv(node if i is None else np.asarray(node)[i])

    return {"embed": walk(tree["embed"]), "ln_f": walk(tree["ln_f"]),
            "layers": [walk(tree["layers"], i) for i in range(cfg.n_layers)]}


def params_to(tree, device):
    """The port's parameter tree (nested dicts and lists of tensors) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device) for v in tree]
    return tree.to(device)
