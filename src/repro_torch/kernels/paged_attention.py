"""Paged-attention decode: the wrapper around the CUDA kernels
(``csrc/paged_attention.cu``), which replace the TPU Pallas kernels
``repro.kernels.paged_attention.paged_attention`` and
``paged_attention_hbm``.

A tensor on the CPU goes to the plain version (``ref.paged_attention_plain``);
a CUDA tensor launches the kernels or raises, with no fallback.

On the card every row's token range is cut into fixed chunks of
``chunk_tokens`` tokens (``chunk_pages = chunk_tokens / block_size`` pages
when the block size divides it): one block per (chunk, KV head, row) stages
its chunk's K and V rows in shared memory with ``cp.async`` and writes an f32
partial (m, l, acc) row per query head; a merge kernel, from the same C call
on the same stream, folds each row's live chunks with the log-sum-exp
rescale.  The grid comes from the table width alone (``chunk_grid``), never
from ``context_lens``, so a call reads no device value and can be captured
in a CUDA graph.  ``num_splits`` keeps the reference's meaning (its split-KV
grid axis) and is accepted (clamped to >= 1), but the kernels' partition is
their own chunking: the function, and the kernels' work, are the same for
every split count.  The plain version still honours it.

``paged_attention.launches`` counts wrapper calls that launch the kernels,
one per call (plain integer; reset it to 0 before a run to prove the run
went through them).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_plain

_GMAX = (1, 2, 4, 8)
CHUNKS = (32, 64, 128)
# tokens of a chunk: the measured best of CHUNKS at the serving shapes
# (B=8, H=8, KH=4, D=256, 64-entry tables of 16-token pages; PERF.md), and
# the autotuner's measured pick there (``chip_smoke.py`` phase autotune,
# device time: page 16, chunk 64 over its shortlist; PERF.md).  The
# default launch config; a tuned dispatch may pass another of CHUNKS.
CHUNK_TOKENS = 64
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("paged_attention")
        fn = lib.paged_attention_launch
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, I, P, P, P, P, P, P, P, P,
                       I, I, I, I, I, I, I, I, I, F, I, F, P]
        fn.restype = I
        _fn = fn
    return _fn


def chunk_grid(NB: int, bs: int, chunk_tokens: int = CHUNK_TOKENS) -> int:
    """Chunks per row, the kernel grid's first axis: ``ceil(NB * bs /
    chunk_tokens)`` from the table width alone."""
    if chunk_tokens not in CHUNKS:
        raise ValueError(f"chunk_tokens must be one of {CHUNKS}, got "
                         f"{chunk_tokens}")
    return -(-NB * bs // chunk_tokens)


def _group_bound(G: int, D: int) -> int:
    gmax = next((g for g in _GMAX if g >= G), None)
    if gmax is None or D > 256 or D % 8:
        raise ValueError(f"paged_attention kernel takes GQA groups <= "
                         f"{_GMAX[-1]} and head_dim <= 256 with head_dim % 8 "
                         f"== 0; got group {G}, head_dim {D}")
    return gmax


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
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the KV pools must be 16-byte aligned")


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    scale=None, window=None, softcap=None, num_splits=1,
                    chunk_tokens=CHUNK_TOKENS):
    """q [B,H,D]; k/v_pages [P,bs,KH,D] bf16; block_tables [B,NB] int32
    (-1 = unbacked); context_lens [B] int32 -> [B,H,D] in q's dtype.

    Decode attention of one new token per row over its paged context, the
    query at position ``ctx - 1``; optional sliding ``window`` and logit
    ``softcap``; rows with ``ctx == 0`` give zeros.  ``num_splits`` (>= 1
    after clamping) selects the plain version's split-KV form on the CPU
    and does not change the card's work; ``chunk_tokens`` (one of
    ``CHUNKS``) is the kernels' chunk on the card."""
    B, H, D = q.shape
    scale = float(scale) if scale is not None else D ** -0.5
    num_splits = max(int(num_splits), 1)
    if (window is not None and window <= 0) or (softcap is not None
                                                 and softcap <= 0):
        raise ValueError("window and softcap must be positive or None")
    NC = chunk_grid(block_tables.shape[1], k_pages.shape[1], chunk_tokens)
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, block_tables, context_lens, scale=scale,
            window=window, softcap=softcap, num_splits=num_splits)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU, not {q.device}")
    _check(q, k_pages, v_pages, block_tables, context_lens)
    P, bs, KH, _ = k_pages.shape
    NB = block_tables.shape[1]
    gmax = _group_bound(H // KH, D)
    out = torch.empty_like(q)
    if B == 0:
        return out
    # f32 scratch: acc [B,H,NC,D], then m and l [B,H,NC]
    n = B * H * NC
    scratch = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    acc = scratch.data_ptr()
    rc = _launcher()(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), acc + 4 * n * D, acc + 4 * n * (D + 1), acc,
        B, H, KH, D, P, bs, NB, gmax, chunk_tokens, scale,
        int(window) if window else 0, float(softcap) if softcap else 0.0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed (rc={rc})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
