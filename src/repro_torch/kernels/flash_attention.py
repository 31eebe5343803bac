"""Blocked flash-attention forward: the wrapper around two CUDA kernels,
which replace the TPU Pallas kernel
``repro.kernels.flash_attention.flash_attention``.

A tensor on the CPU goes to the plain version (``ref.flash_attention_plain``);
a CUDA tensor launches a kernel or raises, with no fallback.

Dispatch (``kernel_for``, a function of dtype, ``acc_dtype`` and D alone,
never of a failure):

* bf16 with ``acc_dtype="f32"`` and D % 16 == 0, D <= 256 launches the
  tensor-core kernel ``csrc/flash_attention_mma.cu`` (``mma.sync`` bf16
  tiles, f32 accumulators, a ``cp.async`` K/V ring);
* f32 inputs, ``acc_dtype="bf16"`` and bf16 with D % 16 == 8 launch the
  CUDA-core kernel ``csrc/flash_attention.cu``: f32 stays full f32 (the
  tensor cores would round it to bf16 or tf32), and the bf16 accumulator
  rounds after every ``block_k`` tile where the Pallas kernel does.

Tiles (``kernel_tiles``): the tensor-core kernel runs 64 query rows of one
head a block and 64-key KV tiles whatever the hints.  The CUDA-core kernel
with ``acc_dtype="f32"`` runs 64 query rows a block (the GQA group's heads
times ``64 // G`` positions) and 64-key KV tiles; with ``"bf16"`` it
honours ``block_k`` (clamped to Skv, as the Pallas kernel clamps it) and
matches the plain version's rounding points.

``flash_attention.launches`` counts the launches of both kernels and
``flash_attention.mma_launches`` those of the tensor-core kernel (plain
integers; reset them to 0 before a run to prove which kernel it took).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ACC_DTYPES, flash_attention_plain

SIMT = "flash_attention"          # the CUDA-core kernel (csrc name)
MMA = "flash_attention_mma"       # the tensor-core kernel (csrc name)
ROWS = 64                 # query rows per block (csrc: kRows, kBM)
SUB = 64                  # KV tile of the f32 path (csrc: kSub, kBN)
SMEM_LIMIT = 232448       # shared memory a Hopper block may use (227 KB)
_NC = (1, 2, 4, 8, 16)
# head dims the tensor-core kernel is built for (csrc: DP); a D in between
# runs at the next one, its extra columns zero
MMA_DIMS = (16, 32, 64, 128, 256)
MMA_SLOTS = 2             # slots of its K/V ring (csrc: kSlots)
_fns = {}


def _launcher(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_launch")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == MMA:
            fn.argtypes = [P, P, P, P, I, I, I, I, I, I, F, I, I, F, P]
        else:
            fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, F, I,
                           I, F, P]
        fn.restype = I
        _fns[name] = fn
    return fn


def kernel_for(dtype, acc_dtype: str, D: int) -> str:
    """The dispatch rule: ``MMA`` (the tensor-core kernel) for bf16 with
    an f32 accumulator and D % 16 == 0, D <= 256; ``SIMT`` (the CUDA-core
    kernel, which refuses what it does not take) for everything else."""
    if (dtype == torch.bfloat16 and acc_dtype == "f32" and D % 16 == 0
            and 0 < D <= MMA_DIMS[-1]):
        return MMA
    return SIMT


def smem_bytes(D: int, lk: int, kernel: str = SIMT) -> int:
    """Dynamic shared memory of one block.  ``SIMT`` (csrc ``smem_bytes``):
    the Q tile and one K/V sub-tile of ``D + 1`` f32 columns, the score
    tile of ``lk + 1`` columns, and three per-row f32 vectors.  ``MMA``
    (csrc ``Tile<DP>::kSmem``): the Q tile and the K/V ring's slots, each
    64 rows of DP + 8 bf16 (``lk`` is its fixed 64)."""
    if kernel == MMA:
        dp = next(d for d in MMA_DIMS if d >= D)
        return 2 * ROWS * (dp + 8) * (1 + MMA_SLOTS)
    return 4 * ((ROWS + SUB) * (D + 1) + ROWS * (lk + 1) + 3 * ROWS)


def kernel_tiles(H: int, KH: int, D: int, Skv: int, block_k: int,
                 acc_dtype: str, dtype):
    """The launch shape of the kernel that ``kernel_for(dtype, acc_dtype,
    D)`` picks, as ``(nc, bq, lk)``.  ``SIMT``: head-dim columns per
    thread, query positions per block, KV tile.  ``MMA``: the padded head
    dim's n8 tiles of O a warp (DP / 8), the block's 64 query positions
    of one head, the 64-key KV tile.  Raises ``ValueError`` on what the
    kernel does not take."""
    if kernel_for(dtype, acc_dtype, D) == MMA:      # takes every such D
        return next(d for d in MMA_DIMS if d >= D) // 8, ROWS, SUB
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
    kernel = kernel_for(q.dtype, acc_dtype, D)
    nc, bq, lk = kernel_tiles(H, KH, D, Skv, block_k, acc_dtype, q.dtype)
    if kernel == MMA and (B > 65535 or -(-Sq // ROWS) > 65535):
        raise ValueError(f"flash_attention_mma: a grid of B={B} x "
                         f"{-(-Sq // ROWS)} query tiles exceeds 65535")
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    tail = (int(bool(causal)), int(window) if window else 0,
            float(softcap) if softcap else 0.0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if kernel == MMA:
        rc = _launcher(MMA)(*ptrs, B, Sq, Skv, H, KH, D, scale, *tail)
    else:
        rc = _launcher(SIMT)(*ptrs, int(q.dtype == torch.bfloat16), B, Sq,
                             Skv, H, KH, D, nc, bq, lk,
                             int(acc_dtype == "bf16"), scale, *tail)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed (rc={rc})")
    flash_attention.launches += 1
    if kernel == MMA:
        flash_attention.mma_launches += 1
    return out


flash_attention.launches = 0
flash_attention.mma_launches = 0
