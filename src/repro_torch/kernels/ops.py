"""Public kernel entry points with launch-config resolution.

Resolution order, as in ``repro.kernels.ops``: explicit argument >
``config=`` mapping > default.  The tuned-cache lookup of the JAX package
waits for the port's autotune slice.  Defaults are the port's own copy of
``repro.core.autotune.space``'s ``flash_attention`` and ``paged_attention``
entries.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa

KERNEL_DEFAULTS = {
    "flash_attention": {"block_q": 128, "block_k": 128, "acc_dtype": "f32"},
    "paged_attention": {"block_size": 16, "num_splits": 1},
}


def resolve_kernel_config(kernel, *, config=None, explicit=None):
    """explicit kwargs > ``config`` mapping > defaults: a complete plain
    dict of launch parameters for ``kernel``."""
    out = dict(KERNEL_DEFAULTS[kernel])
    if config:
        out.update({k: config[k] for k in out if k in config})
    if explicit:
        out.update({k: v for k, v in explicit.items() if v is not None})
    return out


def flash_attention(q, k, v, causal=True, window=None, softcap=None,
                    scale=None, block_q=None, block_k=None, acc_dtype=None,
                    config=None):
    """Blocked forward attention (``kernels.flash_attention``) with
    ``block_q``/``block_k``/``acc_dtype`` resolved explicit > ``config=``
    > default."""
    c = resolve_kernel_config(
        "flash_attention", config=config,
        explicit={"block_q": block_q, "block_k": block_k,
                  "acc_dtype": acc_dtype})
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               block_q=int(c["block_q"]),
                               block_k=int(c["block_k"]),
                               acc_dtype=str(c["acc_dtype"]))


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None, window=None, softcap=None, num_splits=None,
                    config=None):
    """Paged decode attention.  ``block_size`` is a cache-layout parameter
    fixed by ``k_pages.shape[1]``; ``num_splits`` (the split-KV grid axis)
    resolves here and is clamped to the table width, so every split covers
    at least zero whole pages."""
    NB = block_tables.shape[1]
    c = resolve_kernel_config("paged_attention", config=config,
                              explicit={"num_splits": num_splits})
    splits = max(min(int(c["num_splits"]), NB), 1)
    return _pa.paged_attention(q, k_pages, v_pages, block_tables,
                               context_lens, scale=scale, window=window,
                               softcap=softcap, num_splits=splits)
