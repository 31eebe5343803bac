"""Paged-attention decode: the wrapper around the CUDA kernel
(``csrc/paged_attention.cu``), which replaces the TPU Pallas kernels
``repro.kernels.paged_attention.paged_attention`` and
``paged_attention_hbm``.

A tensor on the CPU goes to the plain version (``ref.paged_attention_plain``);
a CUDA tensor launches the kernel or raises, with no fallback.  The split-KV
form launches the kernel with a ``num_splits`` grid axis (partial
``(m, l, acc)`` rows) and merges in plain torch, as the JAX package merges
outside its Pallas kernel.

``paged_attention.launches`` counts kernel launches (plain integer; reset it
to 0 before a run to prove the run went through the kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import merge_partials, paged_attention_plain

_GMAX = (1, 2, 4, 8)
_DPL = (1, 2, 4, 8)
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("paged_attention")
        fn = lib.paged_attention_launch
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, I, P, P, P, P, P, P, P, P,
                       I, I, I, I, I, I, I, I, I, F, I, F, I, P]
        fn.restype = I
        _fn = fn
    return _fn


def _template_bounds(G: int, D: int):
    gmax = next((g for g in _GMAX if g >= G), None)
    dpl = next((d for d in _DPL if 32 * d >= D), None)
    if gmax is None or dpl is None or D % dpl:
        raise ValueError(f"paged_attention kernel takes GQA groups <= "
                         f"{_GMAX[-1]} and head_dim <= {32 * _DPL[-1]} with "
                         f"head_dim % {dpl} == 0; got group {G}, head_dim {D}")
    return gmax, dpl


def _check(q, k_pages, v_pages, block_tables, context_lens):
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
    if k_pages.dtype != torch.bfloat16 or v_pages.dtype != torch.bfloat16:
        raise TypeError("the KV pools must be bf16")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    B, H, D = q.shape
    P, bs, KH, Dk = k_pages.shape
    if Dk != D or KH == 0 or H % KH:
        raise ValueError(f"pools [P,bs,KH,D]={tuple(k_pages.shape)} do not "
                         f"match q [B,H,D]={tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(context_lens.shape) != (B,):
        raise ValueError("block_tables must be [B,NB] and context_lens [B]")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    scale=None, window=None, softcap=None, num_splits=1):
    """q [B,H,D]; k/v_pages [P,bs,KH,D] bf16; block_tables [B,NB] int32
    (-1 = unbacked); context_lens [B] int32 -> [B,H,D] in q's dtype.

    Decode attention of one new token per row over its paged context, the
    query at position ``ctx - 1``; optional sliding ``window`` and logit
    ``softcap``; rows with ``ctx == 0`` give zeros."""
    B, H, D = q.shape
    scale = float(scale) if scale is not None else D ** -0.5
    num_splits = max(int(num_splits), 1)
    if (window is not None and window <= 0) or (softcap is not None
                                                 and softcap <= 0):
        raise ValueError("window and softcap must be positive or None")
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, block_tables, context_lens, scale=scale,
            window=window, softcap=softcap, num_splits=num_splits)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU, not {q.device}")
    _check(q, k_pages, v_pages, block_tables, context_lens)
    P, bs, KH, _ = k_pages.shape
    NB = block_tables.shape[1]
    gmax, dpl = _template_bounds(H // KH, D)
    if num_splits == 1:
        out = torch.empty_like(q)
        m = l = acc = None
    else:
        out = None
        m = torch.empty((B, H, num_splits), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        acc = torch.empty((B, H, num_splits, D), dtype=torch.float32,
                          device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    rc = _launcher()(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), context_lens.data_ptr(),
        ptr(out), ptr(m), ptr(l), ptr(acc), B, H, KH, D, P, bs, NB, gmax, dpl,
        scale, int(window) if window else 0, float(softcap) if softcap else 0.0,
        num_splits, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed (rc={rc})")
    paged_attention.launches += 1
    if num_splits == 1:
        return out
    return merge_partials(m, l, acc, q.dtype)


paged_attention.launches = 0
