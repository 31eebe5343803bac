"""Tensor-core probe: the wrapper around the CUDA WMMA kernel
(``csrc/mxu_probe.cu``), which replaces the TPU Pallas kernel
``repro.kernels.mxu_probe.mxu_probe``.

A tensor on the CPU goes to the plain version (``ref.mxu_probe_plain``); a
CUDA tensor launches the kernel or raises, with no fallback.  Both refuse
what the reference refuses, with its messages: a block that does not divide
the problem, and a dependent chain over a non-square A.  The kernel takes
bf16 (m16n16k16 fragments) or f32 (tf32 m16n16k8 fragments), with every
dimension and block a multiple of 16, and its double-buffered ``[K, bn]``
panel within a block's shared memory.  With ``timing=`` (a CUDA int64 tensor
of 2) it writes the chain's ``clock64()`` cycles and ``%globaltimer``
nanoseconds there.

``mxu_probe.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mxu_probe_plain

SMEM_MAX = 232448                    # 227 KB of shared memory a block
# the kernel's tolerance against the plain version, as a share of the
# plain output's largest magnitude: bf16 rounds each step to 8 bits either
# side of a tie in another summation order; f32 runs as tf32 (10-bit
# inputs, relative error 2^-11 per product, summed over K)
REL_TOL = 2e-2
_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = _build.load("mxu_probe")
        P, I = ctypes.c_void_p, ctypes.c_int
        launch = lib.mxu_probe_launch
        launch.argtypes = [I, P, P, P, I, I, I, I, I, I, P, P]
        launch.restype = I
        smem = lib.mxu_probe_smem_bytes
        smem.argtypes = [I, I, I, I]
        smem.restype = ctypes.c_longlong
        _fns = (launch, smem)
    return _fns


def mxu_probe(a, b, *, chain=4, block=(128, 128), timing=None):
    """a [M,K]; b [K,N] -> [M,N] in b's dtype: per (bm, bn) tile,
    C <- (A @ C) * 0.001 cast to the dtype, ``chain`` times, from C = b."""
    M, K = a.shape
    N = b.shape[1]
    if b.shape[0] != K:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         "chain")
    # the reference's min-clamp; a block that does not divide is refused
    bm, bn = max(min(block[0], M), 1), max(min(block[1], N), 1)
    if M % bm or N % bn:
        raise ValueError(
            f"mxu_probe block ({bm}, {bn}) must divide the problem "
            f"({M}, {N})")
    if chain > 1:
        assert M == K, "a dependent chain needs square A (C <- A @ C)"
    if (bm, bn) != (M, N):
        assert chain == 1 or bm == K
    if a.device.type == "cpu":
        return mxu_probe_plain(a, b, chain=chain)
    if a.device.type != "cuda":
        raise ValueError(f"mxu_probe runs on CUDA or CPU, not {a.device}")
    if b.device != a.device or a.dtype != b.dtype \
            or a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("a and b must be bf16 or f32 tensors of one dtype on "
                        "one device")
    if not (a.is_contiguous() and b.is_contiguous()) \
            or a.data_ptr() % 32 or b.data_ptr() % 32:
        raise ValueError("a and b must be contiguous and 32-byte aligned")
    if any(d % 16 for d in (M, N, K, bm, bn)):
        raise ValueError(f"the WMMA kernel takes dimensions and blocks that "
                         f"are multiples of 16, got M,N,K=({M},{N},{K}), "
                         f"block ({bm},{bn})")
    launch, smem = _launchers()
    is_bf16 = int(a.dtype == torch.bfloat16)
    need = smem(is_bf16, K, bn, int(chain))
    if need > SMEM_MAX:
        raise ValueError(f"the [K={K}, bn={bn}] panel needs {need} bytes of "
                         f"shared memory, more than {SMEM_MAX}")
    if timing is not None and (timing.device != a.device
                               or timing.dtype != torch.int64
                               or timing.numel() < 2
                               or not timing.is_contiguous()):
        raise ValueError("timing must be a contiguous int64 CUDA tensor of 2")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    rc = launch(is_bf16, a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                bm, bn, int(chain),
                None if timing is None else timing.data_ptr(),
                torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mxu_probe kernel launch failed (rc={rc})")
    mxu_probe.launches += 1
    return out


mxu_probe.launches = 0
