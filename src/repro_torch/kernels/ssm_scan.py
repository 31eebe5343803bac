"""Selective-SSM scan: the wrapper around the CUDA kernel
(``csrc/ssm_scan.cu``), which replaces the TPU Pallas kernel
``repro.kernels.ssm_scan.ssm_scan``, and around its gradient's kernel
(``csrc/ssm_scan_bwd.cu``, ``ssm_scan_bwd``), behind ``SsmScanFn``.

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

With grad mode on and an input that requires grad, ``ssm_scan`` runs
through ``SsmScanFn``: the same forward, and ``ssm_scan_bwd`` for the
gradient (on the CPU ``ref.ssm_scan_bwd_plain``, on the card the kernel,
which keeps the state every ``BWD_CHUNK`` steps in a workspace and adds
its channel groups' partials of dB and dC and its rows' of dA in order).

``ssm_scan.launches`` counts forward kernel launches and
``ssm_scan.bwd_launches`` the backward's (plain integers; reset them to 0
before a run to prove the run went through the kernels).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssm_scan_bwd_plain, ssm_scan_plain

STATE_DIMS = (4, 8, 16)       # csrc: the N the kernel is built for
CHANNELS = 8                  # csrc kChannels: channels a block
BWD_CHUNK = 16                # csrc/ssm_scan_bwd.cu kSteps: the state kept
BWD_GROUP = 16                # csrc/ssm_scan_bwd.cu kGroup: channels a block
_fns = {}


def _launcher(name="ssm_scan"):
    """The C entry point of ``csrc/<name>.cu`` (``ssm_scan`` or
    ``ssm_scan_bwd``), bound on first use."""
    if name not in _fns:
        fn = getattr(_build.load(name), f"{name}_launch")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P] * 6 + [I] * 5 + [P] if name == "ssm_scan" else
                       [P] * 12 + [L] + [I] * 5 + [P])
        fn.restype = I
        _fns[name] = fn
    return _fns[name]


def bwd_workspace_floats(Bt, S, Di, N):
    """The backward kernel's f32 workspace: the state at the start of
    every ``BWD_CHUNK`` steps of each (row, channel) (N each), the channel
    groups' partials of dB and dC ([Bt,S,N] each a group) and the rows'
    of dA ([Di,N] a row)."""
    nchunk = -(-S // BWD_CHUNK)
    groups = -(-Di // BWD_GROUP)
    return Bt * nchunk * Di * N + 2 * groups * Bt * S * N + Bt * Di * N


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


def _forward(x, dt, B, C, A, block_d):
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


class SsmScanFn(torch.autograd.Function):
    """``ssm_scan`` with its gradient: the forward kernel, then
    ``ssm_scan_bwd`` on the saved inputs.  ``block_d`` gets no gradient;
    each gradient comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, block_d):
        ctx.save_for_backward(x, dt, B, C, A)
        return _forward(x, dt, B, C, A, block_d)

    @staticmethod
    def backward(ctx, dy):
        xs = ctx.saved_tensors
        grads = ssm_scan_bwd(*xs, dy)
        return tuple(g.to(t.dtype) if need else None for g, t, need in
                     zip(grads, xs, ctx.needs_input_grad)) + (None,)


def ssm_scan(x, dt, B, C, A, *, block_d=256):
    """x [Bt,S,Di] and B, C [Bt,S,N] (bf16 or f32); dt [Bt,S,Di]; A [Di,N]
    -> y [Bt,S,Di] in x's dtype, from a zero f32 state per (row, channel).
    ``block_d`` keeps the Pallas kernel's meaning, its channel tile, and
    must divide Di; on the card the kernel takes its grid from the shapes
    alone (8 channels a one-warp block), so it changes no value.  With
    grad mode on and an input that requires grad, the call goes through
    ``SsmScanFn``."""
    _check_args(x, dt, B, C, A, block_d)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, B, C, A)):
        return SsmScanFn.apply(x, dt, B, C, A, block_d)
    return _forward(x, dt, B, C, A, block_d)


def ssm_scan_bwd(x, dt, B, C, A, dy):
    """The gradient of ``ssm_scan(x, dt, B, C, A)`` at the cotangent
    ``dy`` (cast to x's dtype and made contiguous, as autograd may hand it
    over strided): (dx in x's dtype, ddt f32, dB and dC in B's dtype, dA
    f32).  On CPU tensors ``ref.ssm_scan_bwd_plain``; on CUDA tensors the
    kernel (one launch counted in ``ssm_scan.bwd_launches``), which reads
    dt and A in f32 and takes what the forward kernel takes."""
    _check_args(x, dt, B, C, A, 1)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must be x's shape "
                         f"{tuple(x.shape)}")
    dy = dy.to(x.dtype).contiguous()
    if x.device.type == "cpu":
        return ssm_scan_bwd_plain(x, dt, B, C, A, dy)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd runs on CUDA or CPU, not {x.device}")
    _check_cuda(x, dt, B, C, A)
    if dy.device != x.device or dy.data_ptr() % 16:
        raise ValueError("dy must be 16-byte aligned on x's device")
    dtf, Af = dt.float(), A.float().contiguous()
    Bt, S, Di = x.shape
    N = A.shape[1]
    dx = torch.empty_like(x)
    ddt = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.empty((Di, N), dtype=torch.float32, device=x.device)
    n = bwd_workspace_floats(Bt, S, Di, N)
    ws = torch.empty(n, dtype=torch.float32, device=x.device)
    rc = _launcher("ssm_scan_bwd")(
        x.data_ptr(), dtf.data_ptr(), B.data_ptr(), C.data_ptr(),
        Af.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), ws.data_ptr(), n,
        int(x.dtype == torch.bfloat16), Bt, S, Di, N,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan_bwd kernel launch failed (rc={rc})")
    ssm_scan.bwd_launches += 1
    return dx, ddt, dB, dC, dA


ssm_scan.launches = 0
ssm_scan.bwd_launches = 0
