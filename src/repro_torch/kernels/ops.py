"""Public kernel entry points with launch-config resolution.

Resolution order, as in ``repro.kernels.ops``: explicit argument >
``config=`` mapping > the installed autotuner's cache hit (``tuned=True``
consults ``repro_torch.core.autotune``'s handle) > default.  Defaults come
from ``repro_torch.core.autotune.space``'s registry, whose launch space is
the choices the CUDA kernels take at run time (the paged kernel's
``chunk_tokens``, the tensor-core probe's block, the flash kernel's
accumulator and KV tile); ``divisor_clamp`` is its one implementation.
A resolved value the kernel cannot launch raises (``chunk_tokens`` outside
``kernels.paged_attention.CHUNKS``): a cache entry is never silently
replaced by the default.
"""
from __future__ import annotations

from repro_torch.core.autotune.space import TUNABLES, divisor_clamp
from repro_torch.kernels import alu_chain as _alu
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mxu_probe as _mxu
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import pointer_chase as _chase
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels import wkv6 as _wkv

# kernel name -> default launch config (what launches with no tuning entry)
KERNEL_DEFAULTS = {name: dict(t.default_config)
                   for name, t in TUNABLES.items()}


def resolve_kernel_config(kernel, shapes=None, dtype=None, *, config=None,
                          tuned=False, explicit=None):
    """explicit kwargs > ``config`` mapping > installed-autotuner cache hit
    (``tuned=True``, looked up at ``shapes`` and ``dtype``) > defaults: a
    complete plain dict of launch parameters for ``kernel``."""
    out = dict(KERNEL_DEFAULTS[kernel])
    if config is None and tuned:
        if shapes is None or dtype is None:
            raise ValueError("a tuned lookup needs the problem's shapes and "
                             "dtype")
        from repro_torch.core.autotune import tuned_config
        # the dtype's name ("bfloat16"), as the tuning cache keys it
        config = tuned_config(kernel, shapes, str(dtype).rsplit(".", 1)[-1])
    if config:
        out.update({k: config[k] for k in out if k in config})
    if explicit:
        out.update({k: v for k, v in explicit.items() if v is not None})
    return out


def flash_attention(q, k, v, causal=True, window=None, softcap=None,
                    scale=None, block_q=None, block_k=None, acc_dtype=None,
                    config=None, tuned=False):
    """Blocked forward attention (``kernels.flash_attention``) with
    ``block_q``/``block_k``/``acc_dtype`` resolved explicit > ``config=``
    > tuned > default; with grad mode on and an input that requires grad
    it runs through ``FlashAttentionFn``, whose backward is a kernel."""
    shapes = {"batch": q.shape[0], "seq_q": q.shape[1],
              "seq_kv": k.shape[1], "heads": q.shape[2],
              "kv_heads": k.shape[2], "head_dim": q.shape[3]}
    c = resolve_kernel_config(
        "flash_attention", shapes, q.dtype, config=config, tuned=tuned,
        explicit={"block_q": block_q, "block_k": block_k,
                  "acc_dtype": acc_dtype})
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               block_q=int(c["block_q"]),
                               block_k=int(c["block_k"]),
                               acc_dtype=str(c["acc_dtype"]))


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None, window=None, softcap=None, num_splits=None,
                    chunk_tokens=None, config=None, tuned=False):
    """Paged decode attention.  ``block_size`` is a cache-layout parameter
    fixed by ``k_pages.shape[1]`` (the paged engine reads the tuning cache
    when it lays out its pool, not here).  ``chunk_tokens``, the CUDA
    kernels' token chunk, resolves here (explicit > ``config=`` > tuned >
    ``CHUNK_TOKENS``), looked up at the reference's shapes (``ctx`` = the
    table width in tokens); a value the kernels cannot launch raises.
    ``num_splits`` resolves the same way and is clamped to the table
    width; it keeps the reference's meaning, the split-KV grid axis, and
    selects the plain version's split form on the CPU, but on the card it
    changes neither the function nor the work."""
    NB = block_tables.shape[1]
    shapes = {"batch": q.shape[0], "heads": q.shape[1],
              "kv_heads": k_pages.shape[2], "head_dim": q.shape[2],
              "ctx": NB * k_pages.shape[1]}
    c = resolve_kernel_config("paged_attention", shapes, q.dtype,
                              config=config, tuned=tuned,
                              explicit={"num_splits": num_splits,
                                        "chunk_tokens": chunk_tokens})
    splits = max(min(int(c["num_splits"]), NB), 1)
    return _pa.paged_attention(q, k_pages, v_pages, block_tables,
                               context_lens, scale=scale, window=window,
                               softcap=softcap, num_splits=splits,
                               chunk_tokens=int(c["chunk_tokens"]))


def ssm_scan(x, dt, B, C, A, block_d=None, config=None, tuned=False):
    """The selective scan (``kernels.ssm_scan``) with ``block_d`` resolved
    explicit > ``config=`` > tuned > default 256, then clamped to a divisor of
    d_inner as the Pallas kernel clamps it (256 -> 64 at d_inner 1600).
    It keeps the reference's meaning, the channel tile; the CUDA kernel
    cuts its own grid from the shapes alone (8 channels a one-warp
    block), so on the card it changes neither the function nor the
    work."""
    shapes = {"batch": x.shape[0], "seq": x.shape[1],
              "d_inner": x.shape[2], "state_dim": A.shape[1]}
    c = resolve_kernel_config("ssm_scan", shapes, x.dtype, config=config,
                              tuned=tuned, explicit={"block_d": block_d})
    bd = divisor_clamp(int(c["block_d"]), x.shape[2])
    return _ssm.ssm_scan(x, dt, B, C, A, block_d=bd)


def wkv6(r, k, v, w, u, block_h=None, config=None, tuned=False):
    """The RWKV6 recurrence (``kernels.wkv6``) with ``block_h`` resolved
    explicit > ``config=`` > tuned > default 1, then clamped to a divisor
    of the head count as the Pallas kernel clamps it."""
    shapes = {"batch": r.shape[0], "seq": r.shape[1],
              "heads": r.shape[2], "head_dim": r.shape[3]}
    c = resolve_kernel_config("wkv6", shapes, r.dtype, config=config,
                              tuned=tuned, explicit={"block_h": block_h})
    bh = divisor_clamp(int(c["block_h"]), r.shape[2])
    return _wkv.wkv6(r, k, v, w, u, block_h=bh)


def alu_chain(x, c, op="fma", length=64, dependent=True, timing=None):
    """The paper's ALU chain on one (8,128) tile (``kernels.alu_chain``)."""
    return _alu.alu_chain(x, c, op=op, length=length, dependent=dependent,
                          timing=timing)


def pointer_chase(nxt, start, hops=1024, space="global", cache_op="ca",
                  warm=True, timing=None):
    """The paper's pointer chase (``kernels.pointer_chase``)."""
    return _chase.pointer_chase(nxt, start, hops=hops, space=space,
                                cache_op=cache_op, warm=warm, timing=timing)


def resolve_mxu_block(m, n, block=None, config=None, *, k=None, dtype=None,
                      tuned=False):
    """``(block_m, block_n)``: an explicit ``block`` as given (the kernel
    holds it strictly: for measurement callers the tile is the measured
    quantity); a ``config=``, tuned (looked up at ``m``, ``k``, ``n`` and
    ``dtype``) or default block clamped to a divisor of the problem, as
    ``repro.kernels.ops.mxu_probe`` does."""
    explicit = None if block is None else {"block_m": block[0],
                                           "block_n": block[1]}
    c = resolve_kernel_config("mxu_probe", {"m": m, "k": k, "n": n}, dtype,
                              config=config, tuned=tuned, explicit=explicit)
    bm, bn = int(c["block_m"]), int(c["block_n"])
    if block is None:
        bm, bn = divisor_clamp(bm, m), divisor_clamp(bn, n)
    return bm, bn


def mxu_probe(a, b, chain=4, block=None, config=None, timing=None,
              tuned=False):
    """The tensor-core probe (``kernels.mxu_probe``) with its block
    resolved explicit > ``config=`` > tuned > default (128, 128)."""
    blk = resolve_mxu_block(a.shape[0], b.shape[1], block=block,
                            config=config, k=a.shape[1], dtype=a.dtype,
                            tuned=tuned)
    return _mxu.mxu_probe(a, b, chain=chain, block=blk, timing=timing)
