"""Public kernel entry points with launch-config resolution.

Resolution order, as in ``repro.kernels.ops``: explicit argument >
``config=`` mapping > default.  The tuned-cache lookup of the JAX package
waits for the port's autotune slice.  Defaults are the port's own copy of
``repro.core.autotune.space``'s ``flash_attention``, ``paged_attention``
and ``mxu_probe`` entries, and of its ``divisor_clamp``.
"""
from __future__ import annotations

import math

from repro_torch.kernels import alu_chain as _alu
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mxu_probe as _mxu
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import pointer_chase as _chase

KERNEL_DEFAULTS = {
    "flash_attention": {"block_q": 128, "block_k": 128, "acc_dtype": "f32"},
    "paged_attention": {"block_size": 16, "num_splits": 1},
    "mxu_probe": {"block_m": 128, "block_n": 128},
}


def divisor_clamp(value: int, n: int) -> int:
    """Largest launchable block for a divisor-constrained axis: min-clamp
    to the problem size, then fall back to a common divisor when it does
    not divide."""
    v = max(min(int(value), n), 1)
    return v if n % v == 0 else math.gcd(v, n)


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


def alu_chain(x, c, op="fma", length=64, dependent=True, timing=None):
    """The paper's ALU chain on one (8,128) tile (``kernels.alu_chain``)."""
    return _alu.alu_chain(x, c, op=op, length=length, dependent=dependent,
                          timing=timing)


def pointer_chase(nxt, start, hops=1024, space="global", cache_op="ca",
                  warm=True, timing=None):
    """The paper's pointer chase (``kernels.pointer_chase``)."""
    return _chase.pointer_chase(nxt, start, hops=hops, space=space,
                                cache_op=cache_op, warm=warm, timing=timing)


def resolve_mxu_block(m, n, block=None, config=None):
    """``(block_m, block_n)``: an explicit ``block`` as given (the kernel
    holds it strictly: for measurement callers the tile is the measured
    quantity); a ``config=`` or default block clamped to a divisor of the
    problem, as ``repro.kernels.ops.mxu_probe`` does."""
    explicit = None if block is None else {"block_m": block[0],
                                           "block_n": block[1]}
    c = resolve_kernel_config("mxu_probe", config=config, explicit=explicit)
    bm, bn = int(c["block_m"]), int(c["block_n"])
    if block is None:
        bm, bn = divisor_clamp(bm, m), divisor_clamp(bn, n)
    return bm, bn


def mxu_probe(a, b, chain=4, block=None, config=None, timing=None):
    """The tensor-core probe (``kernels.mxu_probe``) with its block
    resolved explicit > ``config=`` > default (128, 128)."""
    blk = resolve_mxu_block(a.shape[0], b.shape[1], block=block,
                            config=config)
    return _mxu.mxu_probe(a, b, chain=chain, block=blk, timing=timing)
