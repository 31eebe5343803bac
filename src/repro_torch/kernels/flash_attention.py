"""Blocked flash-attention forward: the wrapper around the CUDA kernel
(``csrc/flash_attention.cu``), which replaces the TPU Pallas kernel
``repro.kernels.flash_attention.flash_attention``.

A tensor on the CPU goes to the plain version (``ref.flash_attention_plain``);
a CUDA tensor launches the kernel or raises, with no fallback.

Tiles: with ``acc_dtype="f32"`` the block sizes are hints, and the kernel
runs its own tiles (``kernel_tiles``): 64 query rows a block (the GQA
group's heads times ``64 // G`` positions) and KV tiles of 64 keys.  With
``"bf16"`` the accumulator is rounded after every KV tile, so the kernel
honours ``block_k`` (clamped to Skv, as the Pallas kernel clamps it) and
matches the plain version's rounding points.

``flash_attention.launches`` counts kernel launches (plain integer; reset
it to 0 before a run to prove the run went through the kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ACC_DTYPES, flash_attention_plain

ROWS = 64                 # query rows per block (csrc: kRows)
SUB = 64                  # KV tile of the f32 path (csrc: kSub)
SMEM_LIMIT = 232448       # shared memory a Hopper block may use (227 KB)
_NC = (1, 2, 4, 8, 16)
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_launch
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, F, I, I,
                       F, P]
        fn.restype = I
        _fn = fn
    return _fn


def smem_bytes(D: int, lk: int) -> int:
    """Dynamic shared memory of one block (csrc ``smem_bytes``): the Q
    tile and one K/V sub-tile of ``D + 1`` f32 columns, the score tile of
    ``lk + 1`` columns, and three per-row f32 vectors."""
    return 4 * ((ROWS + SUB) * (D + 1) + ROWS * (lk + 1) + 3 * ROWS)


def kernel_tiles(H: int, KH: int, D: int, Skv: int, block_k: int,
                 acc_dtype: str):
    """The kernel's launch shape for these sizes: ``(nc, bq, lk)`` =
    head-dim columns per thread, query positions per block, KV tile.
    Raises ``ValueError`` on what the kernel does not take."""
    G = H // KH
    if G > ROWS:
        raise ValueError(f"flash_attention kernel takes GQA groups <= {ROWS}, "
                         f"got {G}")
    nc = next((n for n in _NC if 16 * n >= D), None)
    if nc is None or D % 8:
        raise ValueError(f"flash_attention kernel takes head_dim <= "
                         f"{16 * _NC[-1]} with head_dim % 8 == 0, got {D}")
    lk = SUB if acc_dtype == "f32" else max(min(int(block_k), Skv), 1)
    if smem_bytes(D, lk) > SMEM_LIMIT:
        raise ValueError(f"flash_attention: a KV tile of {lk} keys at "
                         f"head_dim {D} needs {smem_bytes(D, lk)} bytes of "
                         f"shared memory > {SMEM_LIMIT}")
    return nc, ROWS // G, lk


def _check_args(q, k, v, window, softcap, acc_dtype):
    """What both the kernel and the plain version require."""
    if acc_dtype not in ACC_DTYPES:
        raise ValueError(f"acc_dtype must be one of {sorted(ACC_DTYPES)}, "
                         f"got {acc_dtype!r}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B,Sq,H,D] and k, v [B,Skv,KH,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, KH, Dk = k.shape
    if Bk != B or Dk != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} KV heads")
    if Sq == 0 or Skv == 0:
        raise ValueError("empty query or key sequence")
    if (window is not None and window <= 0) or (softcap is not None
                                                 and softcap <= 0):
        raise ValueError("window and softcap must be positive or None")


def _check_cuda(q, k, v):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q, k, v must be bf16 or f32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, block_q=128, block_k=128, acc_dtype="f32"):
    """q [B,Sq,H,D]; k,v [B,Skv,KH,D] -> [B,Sq,H,D] in q's dtype.

    Attention of every query over the keys, query i at position i and key
    j at position j: ``causal`` (top-left aligned), optional sliding
    ``window`` and logit ``softcap``, GQA (query head h reads KV head
    h // (H/KH)), online softmax with an ``acc_dtype`` accumulator."""
    _check_args(q, k, v, window, softcap, acc_dtype)
    D = q.shape[-1]
    scale = float(scale) if scale is not None else D ** -0.5
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, block_q=block_q,
                                     block_k=block_k, acc_dtype=acc_dtype,
                                     **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    _check_cuda(q, k, v)
    B, Sq, H, _ = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    nc, bq, lk = kernel_tiles(H, KH, D, Skv, block_k, acc_dtype)
    out = torch.empty_like(q)
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, Sq, Skv, H, KH, D, nc, bq, lk,
        int(acc_dtype == "bf16"), scale, int(bool(causal)),
        int(window) if window else 0, float(softcap) if softcap else 0.0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (rc={rc})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
