"""Selective-SSM scan: the wrapper around the CUDA kernel
(``csrc/ssm_scan.cu``), which replaces the TPU Pallas kernel
``repro.kernels.ssm_scan.ssm_scan``.

A tensor on the CPU goes to the plain version (``ref.ssm_scan_plain``); a
CUDA tensor launches the kernel or raises, with no fallback.  The kernel
reads ``dt`` and ``A`` in f32: the wrapper upcasts them first where they
arrive in another float dtype, as the Pallas kernel upcasts them inside.
The kernel cuts its own grid from the shapes alone: one warp a block for
``CHANNELS`` channels, each channel's states split over 4 lanes.  It takes
d_inner only in multiples of ``CHANNELS`` and 16-byte aligned tensors, and
``block_d``, the Pallas kernel's channel tile, changes neither the grid nor
any value on the card.  The call reads no device value on the host, so it
can be captured in a CUDA graph.

The kernel has no backward: with grad mode on, an input that requires
grad raises ``NotImplementedError`` on every device (``refuse_grad``).

``ssm_scan.launches`` counts kernel launches (plain integer; reset it to 0
before a run to prove the run went through the kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.ref import ssm_scan_plain

STATE_DIMS = (4, 8, 16)       # csrc: the N the kernel is built for
CHANNELS = 8                  # csrc kChannels: channels a block
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("ssm_scan").ssm_scan_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
        fn.restype = I
        _fn = fn
    return _fn


def _check_args(x, dt, B, C, A, block_d):
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x and dt must be [Bt,S,Di]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}")
    Bt, S, Di = x.shape
    if A.dim() != 2 or A.shape[0] != Di:
        raise ValueError(f"A must be [Di,N] with Di={Di}, got "
                         f"{tuple(A.shape)}")
    N = A.shape[1]
    for name, t in (("B", B), ("C", C)):
        if tuple(t.shape) != (Bt, S, N):
            raise ValueError(f"{name} must be [Bt,S,N] = {(Bt, S, N)}, got "
                             f"{tuple(t.shape)}")
    if block_d <= 0 or Di % block_d:
        raise ValueError(f"block_d={block_d} does not divide d_inner {Di}")


def _check_cuda(x, dt, B, C, A):
    Bt, _, Di = x.shape
    N = A.shape[1]
    if N not in STATE_DIMS:
        raise ValueError(f"ssm_scan kernel takes state_dim in {STATE_DIMS}, "
                         f"got {N}")
    if Di % CHANNELS:
        raise ValueError(f"ssm_scan kernel takes d_inner in multiples of "
                         f"{CHANNELS}, got {Di}")
    if Bt > 65535:
        raise ValueError(f"ssm_scan kernel takes at most 65535 rows, got "
                         f"{Bt}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x, B, C must be bf16 or f32, got {x.dtype}")
    for name, t in (("dt", dt), ("B", B), ("C", C), ("A", A)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("B", B), ("C", C)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("dt", dt), ("A", A)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be a float tensor, got {t.dtype}")
    for name, t in (("x", x), ("dt", dt), ("B", B), ("C", C), ("A", A)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # (dt in another float dtype is upcast into a new, aligned tensor)
    for name, t in (("x", x), ("dt", dt), ("B", B), ("C", C)):
        if t.data_ptr() % 16 and (name != "dt" or t.dtype == torch.float32):
            raise ValueError(f"{name} must be 16-byte aligned")


def ssm_scan(x, dt, B, C, A, *, block_d=256):
    """x [Bt,S,Di] and B, C [Bt,S,N] (bf16 or f32); dt [Bt,S,Di]; A [Di,N]
    -> y [Bt,S,Di] in x's dtype, from a zero f32 state per (row, channel).
    ``block_d`` keeps the Pallas kernel's meaning, its channel tile, and
    must divide Di; on the card the kernel takes its grid from the shapes
    alone (8 channels a one-warp block), so it changes no value."""
    _check_args(x, dt, B, C, A, block_d)
    refuse_grad("ssm_scan", x, dt, B, C, A)
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, B, C, A, block_d=block_d)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on CUDA or CPU, not {x.device}")
    _check_cuda(x, dt, B, C, A)
    dt, A = dt.float(), A.float()
    Bt, S, Di = x.shape
    y = torch.empty_like(x)
    rc = _launcher()(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16), Bt, S,
        Di, A.shape[1], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed (rc={rc})")
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0
